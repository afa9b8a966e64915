"""Error-feedback gradient compression through the port against the JAX
package, on the CPU: ``ef_compress_psum`` against the reference's under
a one-device ``shard_map`` (the int8 levels equal bit for bit, at
several group sizes, rounding half to even; the mean and the residual
within two f32 ulps), the
collectives it makes (real gloo all-reduces: MAX on the scale, SUM in
int8, at a world of one too), a world of two processes against the
arithmetic written out in numpy, and 3 ``--compress-grads`` training
steps against the JAX package's."""

import _torch_env  # noqa: F401  (first: one torch thread)
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.launch.train as ref_train
import repro.optim.compression as ref_comp
from repro.configs import get_arch as ref_get_arch
from repro.distributed.sharding import shard_map
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import ef_state_init as ref_ef_state_init
from repro_torch.configs import get_arch
from repro_torch.convert import adamw_state_from_numpy, din_params_from_numpy
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig, compression, ef_state_init
from repro_torch.optim.adamw import tree_leaves

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def group():
    """A gloo world of one, destroyed after the test."""
    with train.process_group(CPU) as g:
        yield g
    assert not dist.is_initialized()


def _leaves(seed: int = 0) -> tuple[dict, dict]:
    """Gradients and residuals of a few shapes; ``halves`` puts values on
    the quantisation grid's half points (amax 127 -> scale 1 at a group
    of one) to hold the rounding to half-to-even."""
    rng = np.random.default_rng(seed)
    grads = {"w": rng.normal(size=(7, 5)).astype(np.float32),
             "b": rng.normal(size=5).astype(np.float32) * 1e-3,
             "halves": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.0],
                                np.float32),
             "zeros": np.zeros(3, np.float32)}
    ef = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32)
          for k, v in grads.items()}
    ef["halves"] = np.zeros_like(grads["halves"])
    return grads, ef


def _ref_compress(grads, ef, axis_size):
    mesh = jax.make_mesh((1,), ("data",))

    def f(g, e):
        mean, new_e = ref_comp.ef_compress_psum(g, e, "data",
                                                axis_size=axis_size)
        levels = max(1, 127 // axis_size)
        qs = jax.tree.map(
            lambda g_, e_: ref_comp._quantize(g_.astype(jnp.float32) + e_,
                                              levels, "data")[0], g, e)
        return mean, new_e, qs

    out = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P()),
                            out_specs=(P(), P(), P())))(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, ef))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("axis_size", [1, 2, 16, 200])
def test_ef_compress_psum_equals_the_reference(group, axis_size):
    """levels = max(1, 127 // axis_size); the int8 q equals the JAX
    package's bit for bit (``torch.round`` and ``jnp.round`` both round
    half to even); the mean ``q * scale / axis_size`` and the residual
    ``x - q * scale`` within two f32 ulps of ``q * scale`` (of the
    mean).  XLA's CPU backend divides by the constant ``levels`` as a
    product with its reciprocal, so its scale may lie an ulp from the
    port's, and it fuses the residual into one FMA; PyTorch rounds each
    operation."""
    grads, ef = _leaves()
    mean, new_e, qs = _ref_compress(grads, ef, axis_size)
    g_t = {k: torch.from_numpy(v) for k, v in grads.items()}
    e_t = {k: torch.from_numpy(v) for k, v in ef.items()}
    got_mean, got_e = compression.ef_compress_psum(g_t, e_t, group,
                                                   axis_size=axis_size)
    levels = max(1, 127 // axis_size)
    for k in grads:
        q, scale = compression._quantize(g_t[k] + e_t[k], levels, group)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), qs[k], err_msg=k)
        np.testing.assert_array_max_ulp(got_mean[k].numpy(), mean[k], 2)
        ulp = np.spacing(np.abs(q.numpy().astype(np.float32)
                                * scale.numpy()))
        assert (np.abs(got_e[k].numpy() - new_e[k]) <= 2 * ulp).all(), k
        assert got_mean[k].dtype == got_e[k].dtype == torch.float32
    if axis_size == 1:     # scale 1: the half points round to even
        np.testing.assert_array_equal(
            qs["halves"], [0, 2, 2, 0, -2, 126, 127])


def test_ef_state_init_mirrors_the_reference():
    grads, _ = _leaves()
    got = ef_state_init({k: torch.from_numpy(v).double()
                         for k, v in grads.items()})
    want = ref_ef_state_init(grads)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and not got[k].any()
        assert tuple(got[k].shape) == v.shape


def test_collectives_are_real_all_reduces_at_a_world_of_one(group,
                                                            monkeypatch):
    """Per leaf one all-reduce MAX of a float32 amax, then one SUM of the
    int8 levels, on the group given: a world of one is not skipped."""
    calls, all_reduce = [], dist.all_reduce

    def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((t.dtype, op, group))
        return all_reduce(t, op=op, group=group, async_op=async_op)

    monkeypatch.setattr(dist, "all_reduce", spy)
    grads, ef = _leaves()
    compression.ef_compress_psum(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in ef.items()}, group, axis_size=1)
    assert calls == [(torch.float32, dist.ReduceOp.MAX, group),
                     (torch.int8, dist.ReduceOp.SUM, group)] * len(grads)


_TWO_RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compression

    rank, path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{path}.store",
                            rank=rank, world_size=2)
    rng = np.random.default_rng(rank)
    g = {"w": torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)
                               * (1 + 3 * rank)),
         "b": torch.from_numpy(rng.normal(size=9).astype(np.float32))}
    e = {k: torch.zeros_like(v) for k, v in g.items()}
    mean, new_e = compression.ef_compress_psum(g, e, axis_size=2)
    np.savez(f"{path}.{rank}.npz", **{f"g_{k}": v.numpy() for k, v in g.items()},
             **{f"mean_{k}": v.numpy() for k, v in mean.items()},
             **{f"e_{k}": v.numpy() for k, v in new_e.items()})
    dist.destroy_process_group()
""")


def test_two_ranks_share_the_scale_and_sum_in_int8(tmp_path):
    """Two gloo processes: the scale is the larger rank's amax / 63, the
    levels are summed in int8, both ranks get the same mean, and each
    keeps its own residual -- equal to the arithmetic written out in
    numpy float32."""
    path = str(tmp_path / "pg")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               path], env=env, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    out = [np.load(f"{path}.{r}.npz") for r in range(2)]
    levels = 127 // 2
    for k in ("w", "b"):
        xs = [o[f"g_{k}"] for o in out]
        scale = np.float32(max(np.abs(x).max() for x in xs)) / \
            np.float32(levels)
        qs = [np.clip(np.round(x / scale), -levels, levels).astype(np.int8)
              for x in xs]
        summed = (qs[0] + qs[1]).astype(np.int8)
        want = summed.astype(np.float32) * scale / np.float32(2)
        for r in range(2):
            np.testing.assert_array_equal(out[r][f"mean_{k}"], want)
            np.testing.assert_array_equal(
                out[r][f"e_{k}"], xs[r] - qs[r].astype(np.float32) * scale)


def test_make_step_needs_the_process_group():
    cfg = get_arch("din").make_reduced()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process_group"):
        train._make_step("din", cfg, AdamWConfig(), "recsys", True,
                         device=CPU)


def test_compressed_steps_match_the_reference(group, monkeypatch):
    """3 ``--compress-grads`` steps of the CLI's step on the CLI's
    batches from the JAX package's weights, optimizer state and a zero
    residual, against the JAX package's step under its one-device
    ``shard_map``: losses within rtol 1e-5; each step's residual finite;
    the params at the end within 1 % (L2) of the distance the JAX
    package's moved them; the residual within 1 % of the JAX package's
    norm plus one f32 ulp of the last step's amax an element (the ulps of
    the test above).  An element whose grad + residual lies within f32
    rounding of a grid half point may round the other way in one package
    (a level apart), so equality is not the contract."""
    scales, quantize = [], compression._quantize

    def recording(x, levels, group):
        q, scale = quantize(x, levels, group)
        scales.append(float(scale) * levels)
        return q, scale

    monkeypatch.setattr(compression, "_quantize", recording)
    cfg = get_arch("din").make_reduced()
    rcfg = ref_get_arch("din").make_reduced()
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=3, master_f32=True)
    rinit, rstep = ref_train._make_step("din", rcfg, RefAdamWConfig(**opt_kw),
                                        "recsys", True)
    rparams = jax.jit(rinit)(jax.random.key(0))
    rstate = {"params": rparams,
              "opt": ref_adamw_init(rparams, RefAdamWConfig(**opt_kw)),
              "ef": ref_ef_state_init(rparams)}
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = din_params_from_numpy(tonp(rparams), device=CPU)
    state = {"params": params,
             "opt": adamw_state_from_numpy(tonp(rstate["opt"]), device=CPU),
             "ef": ef_state_init(params)}
    _, step = train._make_step("din", cfg, AdamWConfig(**opt_kw), "recsys",
                               True, device=CPU)
    got, want = (train._din_batches(cfg, 16, device=CPU),
                 ref_train._din_batches(rcfg, 16))
    start = [np.asarray(v) for v in jax.tree_util.tree_leaves(rparams)]
    losses, ref_losses = [], []
    for _ in range(3):
        state, met = step(state, next(got))
        rstate, rmet = rstep(rstate, next(want))
        losses.append(float(met["loss"]))
        ref_losses.append(float(rmet["loss"]))
        assert all(torch.isfinite(e).all() for e in tree_leaves(state["ef"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    leaves = lambda t: [np.asarray(v) for v in jax.tree_util.tree_leaves(t)]
    for mine, ref, s in zip(tree_leaves(state["params"]),
                            leaves(rstate["params"]), start, strict=True):
        moved = np.linalg.norm(ref - s)
        assert moved > 0
        assert np.linalg.norm(mine.numpy() - ref) <= 1e-2 * moved
    amaxes = scales[-len(start):]
    for mine, ref, amax in zip(tree_leaves(state["ef"]), leaves(rstate["ef"]),
                               amaxes, strict=True):
        assert np.linalg.norm(mine.numpy() - ref) <= \
            1e-2 * np.linalg.norm(ref) + np.sqrt(ref.size) * np.spacing(
                np.float32(amax))
