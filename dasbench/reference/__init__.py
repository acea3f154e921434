"""The plain reference of the DAS model, its decode and its training
step, in plain PyTorch: it imports nothing of the program."""
