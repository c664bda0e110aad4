"""Plain PyTorch references of the configurations. Nothing here imports the program."""
