"""Synthetic corpora (numpy), shared with the JAX package by copy."""

from .synthetic import (FASHION_MNIST, SIFT, DatasetSpec, fashion_mnist_like,
                        gaussian_mixture, sift_like)
