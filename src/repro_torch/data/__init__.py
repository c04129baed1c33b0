from .synthetic import coil_like, mnist_like, swiss_roll

__all__ = ["coil_like", "mnist_like", "swiss_roll"]
