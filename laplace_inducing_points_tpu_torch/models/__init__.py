"""Models of the port: LeNet5 and the toy MLPs, in Flax's parameter layouts."""
