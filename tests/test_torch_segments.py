"""The port's sorted-segment primitives against the JAX package.

Sort order and maxima must be exact. Sums are taken in another order (one
index_add_ against JAX's shift-ladder scan), so they agree to float32
rounding: rtol 1e-6, atol 1e-6 for same-signed terms, as the VFE's point
counts and per-pillar coordinates are (terms of mixed sign cancel, and the
error is then relative to the sum of magnitudes, not to the result).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops import sorted_segments as jseg
from pcp_tpu_torch.ops import sorted_segments as tseg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _sorted_pids(rng, b, n, n_ids):
    return np.sort(rng.integers(0, n_ids, size=(b, n)), axis=1).astype(np.int32)


def test_sort_by_pid_matches_and_is_stable():
    rng = np.random.default_rng(0)
    pid = rng.integers(0, 50, size=(3, 1000)).astype(np.int32)  # many ties
    a2 = rng.standard_normal((3, 1000)).astype(np.float32)
    a3 = rng.standard_normal((3, 1000, 5)).astype(np.float32)
    jp, (ja2, ja3), jorder = jseg.sort_by_pid(jnp.asarray(pid), [jnp.asarray(a2), jnp.asarray(a3)])
    tp, (ta2, ta3), torder = tseg.sort_by_pid(torch.from_numpy(pid),
                                              [torch.from_numpy(a2), torch.from_numpy(a3)])
    for got, want in ((tp, jp), (torder, jorder), (ta2, ja2), (ta3, ja3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(torder.numpy(), np.argsort(pid, axis=1, kind="stable"))


# 3000 runs the JAX flat ladder, 4096 its two-level tiled scan
@pytest.mark.parametrize("n", [3000, 4096])
@pytest.mark.parametrize("reduce", ["sum", "amax"])
def test_segment_total_to_points(n, reduce):
    rng = np.random.default_rng(n)
    pids = _sorted_pids(rng, 2, n, 300)
    pids[1, -100:] = 10_000  # a trailing padding segment
    values = rng.uniform(0, 10, size=(2, n, 4)).astype(np.float32)
    values[..., 1] *= -1  # same-signed within a channel
    combine = jnp.add if reduce == "sum" else jnp.maximum
    want = np.asarray(jseg.segment_total_to_points(jnp.asarray(values), jnp.asarray(pids), combine))
    got = tseg.segment_total_to_points(torch.from_numpy(values), torch.from_numpy(pids), reduce)
    if reduce == "amax":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_ids_number_runs_across_the_batch():
    pids = torch.tensor([[0, 0, 3, 3, 3, 9], [1, 2, 2, 2, 5, 5]], dtype=torch.int32)
    np.testing.assert_array_equal(tseg.segment_ids(pids).numpy(),
                                  [[0, 0, 1, 1, 1, 2], [6, 7, 7, 7, 8, 8]])
