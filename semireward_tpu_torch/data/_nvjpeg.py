"""JPEG decode on the card: nvJPEG through ``csrc/jpeg_decode.cu`` (built and
loaded with ``ctypes`` as the kernels are), and the resize that follows it.

:class:`NvJpeg` holds one nvJPEG handle, and a decode state and a stream for
each host thread that calls it. ``decode`` returns the image as uint8 ``[H,
W, 3]`` on the card with the event that ends its decode (``take`` hands it
to the current stream), or ``None`` where nvJPEG rejects the file (not a
JPEG, a corrupt one) or where it is not a one- or three-component JPEG (CMYK
and YCCK files, which PIL converts with its own formula): the dataset
decodes those on the host. A one-component (grayscale) file decodes to its Y
plane, whose three channels are that plane, as PIL's ``convert("RGB")``
gives. Any other failure (the build, the handle, a state, a launch) raises:
there is no other decode route on the card.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from semireward_tpu_torch.ops import _build

# nvjpegStatus_t values of a file that nvJPEG will not decode
# (NVJPEG_STATUS_BAD_JPEG, NVJPEG_STATUS_JPEG_NOT_SUPPORTED)
REJECTED = (3, 4)
_CUDA_ERROR = 1000  # csrc/jpeg_decode.cu: kCudaError + cudaError_t


def _lib():
    lib = _build.load("jpeg_decode")
    if not getattr(lib, "_srt_typed", False):
        p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        pp = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("srt_jpeg_version", []),
                ("srt_jpeg_handle_create", [pp]),
                ("srt_jpeg_handle_destroy", [p]),
                ("srt_jpeg_state_create", [p, pp]),
                ("srt_jpeg_state_destroy", [p]),
                ("srt_jpeg_info", [p, ctypes.c_char_p, ctypes.c_size_t,
                                   pi, pi, pi, pi]),
                ("srt_jpeg_decode", [p, p, ctypes.c_char_p, ctypes.c_size_t,
                                     i, p, i, p])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        lib._srt_typed = True
    return lib


def check(status: int, what: str) -> None:
    """Raise for a status that is not success."""
    if status >= _CUDA_ERROR:
        raise RuntimeError(f"{what}: CUDA error {status - _CUDA_ERROR}")
    if status != 0:
        raise RuntimeError(f"{what} failed with nvjpegStatus_t {status}")


def take(decoded) -> torch.Tensor:
    """A decoded ``(image, event)`` for use on the current stream: the
    stream waits for the decode, and the image's memory is kept from its
    decode stream until the current stream's work on it is done."""
    img, done = decoded
    cur = torch.cuda.current_stream(img.device)
    cur.wait_event(done)
    img.record_stream(cur)
    return img


def resize_square(img: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 ``[H, W, 3]`` -> uint8 ``[size, size, 3]`` on ``img``'s
    device: bilinear with antialiasing (PIL's ``BILINEAR`` filter, whose
    support widens with the downscale factor), rounded and clamped. Within
    one level of PIL's fixed-point resize on the same pixels."""
    if img.shape[0] == size and img.shape[1] == size:
        return img.contiguous()
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.round_().clamp_(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


class NvJpeg:
    """nvJPEG on ``device``: one handle; each host thread that decodes has
    its own decode state (a state serves one decode at a time) and its own
    stream, so that a decode neither queues behind the training step's
    work on the default stream nor behind another thread's decode."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, not "
                             f"{self.device}")
        self._lib = _lib()
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            check(self._lib.srt_jpeg_handle_create(ctypes.byref(handle)),
                  "nvjpegCreateSimple")
        self._handle = handle
        self._local = threading.local()
        self._states = []
        self._lock = threading.Lock()

    def version(self) -> int:
        return self._lib.srt_jpeg_version()

    def _state(self) -> ctypes.c_void_p:
        state = getattr(self._local, "state", None)
        if state is None:
            state = ctypes.c_void_p()
            check(self._lib.srt_jpeg_state_create(self._handle,
                                                  ctypes.byref(state)),
                  "nvjpegJpegStateCreate")
            with self._lock:
                self._states.append(state)
            self._local.state = state
        return state

    def _stream(self) -> torch.cuda.Stream:
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def decode(self, data: bytes):
        """The file's bytes -> ``(image, event)``: uint8 ``[H, W, 3]`` on
        the card, decoded on the calling thread's stream, and the event
        that marks the decode's end there (:func:`take` waits for it); or
        ``None`` where nvJPEG rejects the file or it is not a 1- or
        3-component JPEG."""
        lib = self._lib
        comps, w, h, css = (ctypes.c_int() for _ in range(4))
        status = lib.srt_jpeg_info(self._handle, data, len(data),
                                   ctypes.byref(comps), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(css))
        if status in REJECTED:
            return None
        check(status, "nvjpegGetImageInfo")
        if comps.value not in (1, 3):
            return None
        gray = comps.value == 1
        stream = self._stream()
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            out = torch.empty((h.value, w.value, 1 if gray else 3),
                              dtype=torch.uint8, device=self.device)
            status = lib.srt_jpeg_decode(
                self._handle, self._state(), data, len(data), int(gray),
                out.data_ptr(), w.value * out.shape[2], stream.cuda_stream)
            if status in REJECTED:
                return None
            check(status, "nvjpegDecode")
            done = torch.cuda.Event()
            done.record(stream)
        return (out.expand(-1, -1, 3) if gray else out), done

    def close(self) -> None:
        """Destroy the states and the handle (after the stream's work)."""
        if self._handle is None:
            return
        torch.cuda.synchronize(self.device)
        for state in self._states:
            self._lib.srt_jpeg_state_destroy(state)
        self._states.clear()
        self._lib.srt_jpeg_handle_destroy(self._handle)
        self._handle = None
