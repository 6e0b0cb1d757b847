"""Dataset augmentation CLIs: ``traditional_augment`` (geometric and
photometric, no cv2)."""
