"""The plain reference: plain PyTorch (float32, TF32 off), NumPy and SciPy.
It imports nothing of the program under test."""
