"""The yardstick of the kernels' roofline shares: the card's published peaks
and the least time of each piece of work the cells ask for.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 3.35 TB/s
of HBM3 and 495 TFLOP/s TF32 on the tensor cores.  An fp32-accurate
product on the tensor cores is three TF32 products
(3xTF32), so products are counted at 3 x 2 flops / 495 TFLOP/s: no
fp32-accurate implementation can take less.

Each function counts the work the cell's inputs need (each input byte read
once, each output byte written once), never what one kernel does, so a
later change that replaces a kernel leaves the count true.  A share is the
least time over the measured device time: at most 100 %.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12


def least_s(nbytes: float, products_3xtf32: float = 0.0) -> float:
    """The larger of the bytes at the memory rate and the fp32 products at
    the tensor cores' rate as 3xTF32, 2 flops each."""
    return max(nbytes / HBM_BYTES_PER_S,
               3 * 2 * products_3xtf32 / TF32_FLOP_PER_S)


def ivf_search_s(q: int, n: int, d: int, nlist: int, nprobe: int,
                 k: int) -> float:
    """One batch of an IVF search: q·nprobe·(n/nlist) candidate products of
    width d, every row read once (at q·nprobe far above nlist every list
    is probed), the queries, and (q, k) ids and distances written."""
    products = q * nprobe * (n / nlist) * d
    nbytes = 4 * n * d + 4 * q * d + 8 * q * k
    return least_s(nbytes, products_3xtf32=products)
