"""The plain reference: the port's model equations in plain PyTorch,
float32 with TF32 off, computed in blocks. It imports nothing of the
port, of JAX or of the JAX package, and takes only the harness's
inputs (weights made from the seed, token ids)."""
