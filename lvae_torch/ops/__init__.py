"""GP algebra on tensors: linear algebra, kernels, posterior prediction."""
