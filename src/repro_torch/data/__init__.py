"""Data: synthetic corpora (numpy, shared with the JAX package by copy) and
the host pipeline that prefetches batches onto the device."""

from .pipeline import Prefetcher, device_put_batches, host_slice
from .synthetic import (FASHION_MNIST, SIFT, DatasetSpec, TokenBatch,
                        fashion_mnist_like, gaussian_mixture, lm_batches,
                        make_corpus, sift_like, zipf_tokens)
