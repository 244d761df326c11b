"""Datasets and CNN training data: synthetic scenes, the device-resident
patch stacks and augmentation, and the host pipeline (patch sets on disk,
samplers, augmentation with OpenCV and Pillow written out, targets,
loaders)."""
