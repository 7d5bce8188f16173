"""The port's windowed chunk gather against the JAX package's.

On the CPU the port's ``windowed_chunk_gather`` is its plain version; the
JAX side runs its Pallas kernel in interpret mode. A gather is a copy, so
the two must agree bit for bit. The stores carry ``STORE_TAIL_SLACK`` zero
rows after their frames, as the staged store does, so that a chunk whose
region runs past the last frame reads the slack on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.ops.window_gather_pallas import (
    windowed_chunk_gather as jax_gather,
)
from pytorch_scalablefhvae_tpu_torch.data.device_store import STORE_TAIL_SLACK
from pytorch_scalablefhvae_tpu_torch.ops import window_gather
from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
    windowed_chunk_gather,
    windowed_chunk_gather_reference,
)


def staged_store(rng, frames, d):
    data = np.zeros((frames + STORE_TAIL_SLACK, d), np.float32)
    data[:frames] = rng.standard_normal((frames, d))
    return data


@pytest.mark.parametrize("spb,seg_len,stride,d", [
    (16, 20, 8, 80),   # the dev MAP pass of the fhvae CLI defaults
    (4, 20, 8, 6),     # D * 4 not a multiple of 16
    (3, 5, 2, 8),
    (5, 7, 7, 12),     # windows that do not overlap
], ids=lambda v: str(v))
def test_plain_gather_equals_jax_kernel(spb, seg_len, stride, d):
    rng = np.random.default_rng(spb * 100 + d)
    frames = 300
    store = staged_store(rng, frames, d)
    region = (spb - 1) * stride + seg_len
    # the last start's region runs past the frames into the slack
    starts = np.array([0, 1, 37, 150, frames - region + 3, frames - 2],
                      np.int32)
    got = windowed_chunk_gather(torch.from_numpy(store),
                                torch.from_numpy(starts), spb, seg_len, stride)
    want = np.asarray(jax_gather(jnp.asarray(store), jnp.asarray(starts),
                                 spb=spb, seg_len=seg_len, stride=stride,
                                 interpret=True))
    assert got.shape == (len(starts) * spb, seg_len, d)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same windows, one jnp.take each
    win = (starts[:, None] + stride * np.arange(spb)[None, :]).reshape(-1)
    take = np.asarray(jnp.take(jnp.asarray(store),
                               win[:, None] + np.arange(seg_len)[None, :],
                               axis=0))
    np.testing.assert_array_equal(got.numpy(), take)
    assert got[-spb:].abs().sum() > 0  # the last chunk starts in the frames


def test_rows_outside_the_store_read_zero():
    store = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    got = windowed_chunk_gather_reference(store, torch.tensor([8, -2]),
                                          spb=2, seg_len=3, stride=1)
    want = torch.zeros((4, 3, 4))
    want[0, :2] = store[8:10]       # rows 8, 9, then 10 (outside)
    want[1, :1] = store[9:10]       # rows 9, 10, 11
    want[2, 2] = store[0]           # rows -2, -1, 0
    want[3, 1:] = store[0:2]        # rows -1, 0, 1
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    store = torch.randn((64, 8))
    starts = torch.tensor([0, 9, 30], dtype=torch.int32)
    before = window_gather.windowed_chunk_gather.launches
    got = windowed_chunk_gather(store, starts, 4, 5, 3)
    assert window_gather.windowed_chunk_gather.launches == before
    assert torch.equal(got, windowed_chunk_gather_reference(store, starts, 4,
                                                            5, 3))


@pytest.mark.parametrize("store,starts", [
    (torch.zeros((8, 4), dtype=torch.float64), torch.tensor([0])),
    (torch.zeros((8, 4)), torch.tensor([0.0])),
    (torch.zeros((2, 8, 4)), torch.tensor([0])),
], ids=["float64 store", "float starts", "3-D store"])
def test_bad_inputs_raise(store, starts):
    with pytest.raises(ValueError):
        windowed_chunk_gather(store, starts, 2, 3, 1)



@pytest.mark.parametrize("row_bytes,ptrs,want", [
    (320, (0, 256), 16),    # float32 at D 80
    (160, (512, 0), 16),    # bfloat16 at D 80
    (24, (0, 0), 4),        # float32 at D 6
    (320, (4, 0), 4),       # a float32 view off a 16-byte boundary
    (12, (0, 0), 4),        # bfloat16 at D 6
    (14, (0, 0), None),     # bfloat16 at D 7: no copy width fits
    (16, (2, 0), None),     # a bfloat16 view off a 4-byte boundary
], ids=lambda v: str(v))
def test_copy_width(row_bytes, ptrs, want):
    """The kernel's copy width, the widest of 16 and 4 bytes that divides a
    row and every address; where neither does, the wrapper raises instead
    of launching."""
    if want is None:
        with pytest.raises(ValueError, match="16 or 4 bytes"):
            window_gather.copy_bytes(row_bytes, *ptrs)
    else:
        assert window_gather.copy_bytes(row_bytes, *ptrs) == want
