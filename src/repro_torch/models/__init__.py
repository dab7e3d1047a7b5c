"""The paper's own models, in PyTorch (VGG16 so far), and the toy
stacked-block MLP the round-step tests use."""
