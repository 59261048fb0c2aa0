"""Keras-style layers on ``torch.nn.Module`` (the slice BERT needs)."""
