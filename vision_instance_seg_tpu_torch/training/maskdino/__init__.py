"""MaskDINO CLIs: ``train_original``, ``train_full``, ``train_experiments``,
``evaluate`` and ``visualize``, over ``common``'s config and datasets."""
