"""The benchmark's plain reference: the models it measures written out in
plain PyTorch, float32, from their published description, with nothing of
the program under test imported. Parameters are a dict of tensors keyed by
the names the program's modules give them, so that one set of weights made
by the benchmark can be handed to both sides."""
