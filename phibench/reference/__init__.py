"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the program: the benchmark hands them the weights and inputs it
made itself, and they judge what the program produced."""
