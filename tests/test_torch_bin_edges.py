"""Points on bin edges, on the CPU: the port's exact division
(`geometry.div_exact`) and its binning functions against the JAX package.

`div_exact(x, d)` divides by a 0-dim tensor of x's dtype on x's device, so
that the card rounds a division by a scalar as the CPU does (a CUDA
division by a Python scalar multiplies by the scalar's reciprocal). On the
CPU it must be `x / d` bit for bit.

The reference has two roundings at a bin edge. Eager JAX divides exactly;
compiled (jitted) JAX code on the CPU multiplies by fl(1 / d), as XLA's
simplifier rewrites a division by a constant. The port divides exactly on
every device, so at the edges it follows eager JAX: the binning tests run
the JAX functions under `jax.disable_jit()` and hold every bin identical,
on the points whose atan2 rounds alike in XLA and in PyTorch (XLA's and
PyTorch's float32 atan2 differ in the last bit on some inputs, which is
not a binning question). Clouds: tests/torch_bin_edges.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_bin_edges as edges

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import erasor as jerasor
from dr_using_scv_od_tpu.models import gicp as jgicp
from dr_using_scv_od_tpu.models import patchwork as jpatchwork
from dr_using_scv_od_tpu.models import scan_context as jscan_context
from dr_using_scv_od_tpu.ops import quantize as jquantize
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.models import (erasor, gicp, patchwork,
                                              scan_context)
from dr_using_scv_od_tpu_torch.ops import geometry, quantize

DIVISORS = (1.2, 0.4, 2.0, 0.08, 0.2, 1.0, 3.0, 2 * np.pi / 54,
            np.pi / 8, 2 * np.pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", DIVISORS)
def test_div_exact_is_the_cpu_division(d, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        edges.around(d * np.arange(-500, 500)),
        rng.uniform(-400, 400, 5000).astype(np.float32)])).to(dtype)
    got, want = geometry.div_exact(x, d), x / d
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert bool((torch.signbit(got) == torch.signbit(want)).all())


def test_compiled_jax_divides_by_the_reciprocal():
    """The reference's two roundings at a sector edge of 1.2 degrees."""
    x = edges.around(1.2 * np.arange(1, 300))
    eager = np.asarray(jnp.asarray(x) / 1.2)
    compiled = np.asarray(jax.jit(lambda v: v / 1.2)(x))
    np.testing.assert_array_equal(eager, x / np.float32(1.2))
    np.testing.assert_array_equal(compiled,
                                  x * (np.float32(1) / np.float32(1.2)))
    assert (eager != compiled).any()
    np.testing.assert_array_equal(
        geometry.div_exact(torch.from_numpy(x), 1.2).numpy(), eager)


def _same_atan2(xyz, ego=(0.0, 0.0, 0.0)):
    """The points of `xyz` whose atan2(y, x) and atan2(z, r) (relative to
    `ego`) are bit-identical in eager JAX and in the port."""
    rel = xyz - np.asarray(ego, np.float32)
    x, y, z = (rel[:, i] for i in range(3))
    jr = jnp.sqrt(jnp.asarray(x * x + y * y))
    j = (np.asarray(jnp.arctan2(y, x)), np.asarray(jnp.arctan2(z, jr)))
    t = torch.from_numpy(rel)
    tr = geometry.range2d(t)
    p = (torch.atan2(t[:, 1], t[:, 0]).numpy(),
         torch.atan2(t[:, 2], tr).numpy())
    keep = (j[0] == p[0]) & (j[1] == p[1])
    assert keep.sum() > 0.5 * len(keep)
    return rel[keep] + np.asarray(ego, np.float32)


def _inputs(xyz):
    return (torch.from_numpy(xyz), torch.ones(len(xyz), dtype=torch.bool),
            jnp.asarray(xyz), jnp.ones(len(xyz), bool))


@pytest.mark.parametrize("axis", ["sector", "range", "azimuth"])
def test_quantize_on_bin_edges_matches_eager_jax(axis):
    grid, jgrid = config.semantickitti().grid, jconfig.semantickitti().grid
    x, v, jx, jv = _inputs(_same_atan2(edges.quantize_cloud(grid, axis)))
    with jax.disable_jit():
        want = jquantize.quantize(jx, jv, jgrid)
    got = quantize.quantize(x, v, grid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_patch_ids_on_bin_edges_match_eager_jax(axis):
    pw, jpw = (c.semantickitti().patchwork for c in (config, jconfig))
    x, v, jx, jv = _inputs(_same_atan2(edges.patchwork_cloud(pw, axis)))
    with jax.disable_jit():
        want = np.asarray(jpatchwork._patch_id(jx, jv, jpw))
    np.testing.assert_array_equal(patchwork._patch_id(x, v, pw).numpy(), want)


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_scan_context_on_bin_edges_matches_eager_jax(axis):
    dc, jdc = scan_context.DescriptorConfig(), jscan_context.DescriptorConfig()
    xyz = _same_atan2(edges.ring_sector_cloud(
        dc.min_range, dc.max_range, dc.rings, dc.sectors, axis))
    xyz[:, 2] = np.arange(len(xyz), dtype=np.float32) * 1e-3
    x, v, jx, jv = _inputs(xyz)
    with jax.disable_jit():
        want = np.asarray(jscan_context.descriptor(jx, jv, jdc))
    np.testing.assert_array_equal(scan_context.descriptor(x, v, dc).numpy(),
                                  want)


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_erasor_bins_on_bin_edges_match_eager_jax(axis):
    ec, jec = erasor.ErasorConfig(), jerasor.ErasorConfig()
    ego = (3.0, -2.0, 0.0)
    x, v, jx, jv = _inputs(_same_atan2(edges.ring_sector_cloud(
        ec.min_range, ec.max_range, ec.num_rings, ec.num_sectors, axis, ego),
        ego))
    with jax.disable_jit():
        want = jerasor._bin_index(jx, jv, jnp.asarray(ego, jnp.float32), jec)
    got = erasor._bin_index(x, v, torch.tensor(ego), ec)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gicp_voxels_on_bin_edges_match_eager_jax():
    gc, jgc = (c.semantickitti().gicp for c in (config, jconfig))
    x, v, jx, jv = _inputs(edges.voxel_cloud(gc))
    with jax.disable_jit():
        want = jgicp.voxel_index(jx, jv, jgc)
    got = gicp.voxel_index(x, v, gc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
