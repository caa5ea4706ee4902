"""The benchmark's plain reference: float32 networks, training steps and
decode in plain PyTorch, NumPy and SciPy. It imports nothing of the program
under test."""
