"""The paper's own models, in PyTorch (VGG16 so far)."""
