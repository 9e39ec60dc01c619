"""Host-side data pipeline: train/eval datasets, augmentations, loader.

All augmentation runs in numpy/PIL/cv2 on the host (no torch/torchvision);
normalisation happens here so device code receives ready tensors.
"""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FILL_COLOR = (124, 116, 104)  # ~ImageNet mean * 255 (reference fill color)
