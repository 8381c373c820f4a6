"""Llama model, int8 quantization and KV-cache decoding (PyTorch port)."""
