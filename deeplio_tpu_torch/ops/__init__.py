"""Device ops: ring projection (CUDA kernel + plain version), masked LSTM."""
