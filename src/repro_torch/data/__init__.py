"""Synthetic corpora (numpy), shared with the JAX package by copy."""

from .synthetic import (FASHION_MNIST, SIFT, DatasetSpec, TokenBatch,
                        fashion_mnist_like, gaussian_mixture, lm_batches,
                        sift_like, zipf_tokens)
