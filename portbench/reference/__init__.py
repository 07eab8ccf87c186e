"""The benchmark's plain reference: the R-CED family's layer specs, the
analysis and rebuild chains, the training mixes, the forward pass, the
loss and TF-Adam, in numpy and plain torch.  It imports nothing of the
program and nothing of JAX, and is given nothing that the program made."""
