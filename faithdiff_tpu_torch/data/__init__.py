"""Training data: the paired HR / LR dataset and its background loaders."""
