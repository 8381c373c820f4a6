"""Llama model and loss, int8 quantization and KV-cache decoding (PyTorch
port)."""
