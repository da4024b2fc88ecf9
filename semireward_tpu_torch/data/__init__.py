"""Data of the port: datasets, splits, samplers and on-device augmentation."""
