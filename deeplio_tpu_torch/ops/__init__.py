"""Device ops: ring and point-scatter projection (each a CUDA kernel and
its plain version), yaw augmentation, masked LSTM."""
