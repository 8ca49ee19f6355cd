"""The benchmark's plain reference: float32 PyTorch (TF32 off) that works
out again what the program under test derives, from the same inputs. It
imports nothing of the program, of JAX or of the JAX package."""
