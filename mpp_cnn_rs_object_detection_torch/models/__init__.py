"""U-Net models, their checkpoint loading and the CNN inference paths."""
