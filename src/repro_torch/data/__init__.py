from .synthetic import batch_for, batch_specs, coil_like, mnist_like, swiss_roll

__all__ = ["batch_for", "batch_specs", "coil_like", "mnist_like", "swiss_roll"]
