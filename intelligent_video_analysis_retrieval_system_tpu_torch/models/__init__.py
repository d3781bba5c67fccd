"""CLIP towers (PyTorch), weight conversion and the tokenizer."""
