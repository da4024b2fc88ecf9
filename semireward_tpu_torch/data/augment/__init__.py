from semireward_tpu_torch.data.augment.pipeline import (  # noqa: F401
    AugmentSpec, augment_views, normalize, strong_augment, weak_augment,
)
