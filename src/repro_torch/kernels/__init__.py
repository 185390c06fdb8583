"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatch between them (:mod:`.ops`)."""
