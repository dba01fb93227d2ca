"""The median networks of ``add_median_kernel`` (csrc/level.cu), read where
the kernel takes them (the TF_MEDIAN_9 and TF_MEDIAN_25 macros):

  * by the 0-1 principle, each network leaves the median of its n inputs
    on wire n // 2 for every one of the 2^n inputs of 0s and 1s, and so
    for every input (a compare-exchange network commutes with monotone
    maps). All 2^25 inputs run at once, bit-parallel: wire i is one uint64
    array whose bit m is bit i of input m, and a compare-exchange is
    (a & b, a | b);
  * applied in PyTorch to seeded windows with ties and both zeros, each
    network gives ``median_plain``'s value and the JAX package's
    ``tpuflow/ops/median.py::median``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuflow.ops.median import median as jax_median

from tpuflow_torch.ops.cuda_lib import CSRC
from tpuflow_torch.ops.median import median_plain
from tpuflow_torch.tools.roofline import MEDIAN_NETWORK


def network(n: int) -> list:
    """The (i, j) pairs of TF_MEDIAN_<n> in csrc/level.cu, in order."""
    src = (CSRC / "level.cu").read_text()
    m = re.search(rf"#define TF_MEDIAN_{n}\(X\)((?:.*\\\n)*.*\n)", src)
    assert m, f"TF_MEDIAN_{n} not found in level.cu"
    return [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", m.group(1))]


def wires(n: int) -> list:
    """Wire i over all 2^n inputs m: bit m of the packed array is bit i of m."""
    words = max(1, (1 << n) // 64)
    out = []
    for i in range(n):
        if i < 6:
            bits = (np.arange(64) >> i) & 1
            word = np.uint64(int("".join(str(b) for b in bits[::-1]), 2))
            out.append(np.full(words, word, dtype=np.uint64))
        else:
            set_ = ((np.arange(words) >> (i - 6)) & 1).astype(bool)
            out.append(np.where(set_, np.uint64(2**64 - 1), np.uint64(0)))
    return out


def majority(n: int) -> np.ndarray:
    """Packed bits, bit m set where input m has more than n // 2 ones."""
    m = np.arange(1 << n, dtype=np.uint32)
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    ones = sum(table[(m >> s) & 0xFF] for s in range(0, 32, 8))
    bits = (ones > n // 2).astype(np.uint8)
    bits = np.concatenate([bits, np.zeros((-len(bits)) % 64, np.uint8)])
    return np.packbits(bits, bitorder="little").view(np.uint64)


@pytest.mark.parametrize("n", [9, 25])
def test_network_selects_the_median_of_every_01_input(n):
    pairs = network(n)
    assert len(pairs) == MEDIAN_NETWORK[n]
    assert all(0 <= i < n and 0 <= j < n and i != j for i, j in pairs)
    w = wires(n)
    for i, j in pairs:
        w[i], w[j] = w[i] & w[j], w[i] | w[j]
    got = w[n // 2]
    if n < 6:
        got = got & np.uint64((1 << (1 << n)) - 1)
    assert np.array_equal(got, majority(n))


def test_a_wrong_network_fails_the_01_check():
    pairs = network(25)[:-1]
    w = wires(25)
    for i, j in pairs:
        w[i], w[j] = w[i] & w[j], w[i] | w[j]
    assert not np.array_equal(w[12], majority(25))


def network_median(img: torch.Tensor, r: int) -> torch.Tensor:
    """The kernel's selection in PyTorch: the reflected r x r windows of
    img (h, w), the pairs as elementwise min and max."""
    h, w = img.shape
    p = F.pad(img[None], (r // 2,) * 4, mode="reflect")[0]
    a = [p[dy:dy + h, dx:dx + w] for dy in range(r) for dx in range(r)]
    for i, j in network(r * r):
        a[i], a[j] = torch.minimum(a[i], a[j]), torch.maximum(a[i], a[j])
    return a[r * r // 2]


@pytest.mark.parametrize("r", [3, 5])
@pytest.mark.parametrize("h,w", [(7, 9), (16, 33), (40, 23)])
def test_network_in_torch_matches_the_plain_and_jax_medians(h, w, r):
    rng = np.random.default_rng(h * w + r)
    # few distinct values, so windows hold ties, and both zeros
    img = rng.choice(np.array([-2.5, -1.0, -0.0, 0.0, 0.5, 3.0], np.float32), size=(h, w))
    img[rng.random((h, w)) < 0.3] = rng.standard_normal(1).astype(np.float32)[0]
    t = torch.from_numpy(img)
    got = network_median(t, r)
    assert torch.equal(got, median_plain(t, r))
    assert np.array_equal(got.numpy(), np.asarray(jax_median(jnp.asarray(img), r)))
