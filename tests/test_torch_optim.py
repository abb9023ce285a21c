"""The port's optimizer library (``repro_torch.optim``) against the
reference's ``repro.optim`` on the same numpy inputs from a seed: every
schedule at steps 0-200, SGD with and without momentum and AdamW with and
without weight decay over 20 steps of a fixed gradient sequence on mixed
f32/bf16 leaves, the global-norm clip at and past its limit, and the
reference's quadratic-minimisation test mirrored.

Tolerances: f32 values within rtol 1e-6 of the reference (the same f32
arithmetic in the same order; the transcendental functions may differ by an
ulp); bf16 updates and parameters within one bf16 ulp (2**-7 of the larger
magnitude), where an ulp-level f32 difference can round the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_thread  # noqa: F401

from repro import optim as ref
from repro_torch import optim

F32_RTOL = 1e-6
BF16_REL = 2.0 ** -7


def _leaves_spec():
    """(path, shape, dtype) of a nested tree with f32 and bf16 leaves."""
    return [(("a",), (3, 4), "float32"), (("b", "c"), (5,), "bfloat16"),
            (("b", "d"), (2, 2, 2), "float32"), (("e", 0), (7,), "bfloat16"),
            (("e", 1), (3,), "float32")]


def _trees(arrays):
    """The same values as a JAX tree and a torch tree: {"a", "b": {"c",
    "d"}, "e": [..]}."""
    jt = {"a": None, "b": {"c": None, "d": None}, "e": [None, None]}
    tt = {"a": None, "b": {"c": None, "d": None}, "e": [None, None]}
    for (path, _, dtype), x in zip(_leaves_spec(), arrays):
        j = jnp.asarray(x).astype(jnp.dtype(dtype))
        t = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
        dj, dt = jt, tt
        for k in path[:-1]:
            dj, dt = dj[k], dt[k]
        dj[path[-1]], dt[path[-1]] = j, t
    return jt, tt


def _draw(rng, scale=1.0):
    return [rng.standard_normal(shape).astype(np.float32) * scale
            for _, shape, _ in _leaves_spec()]


def _assert_close(jx, tt, what):
    """Leaf by leaf: f32 within F32_RTOL, bf16 within one bf16 ulp."""
    for j, t in zip(jax.tree.leaves(jx), optim.tree_leaves(tt)):
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), what
        want = np.asarray(j.astype(jnp.float32))
        got = t.to(torch.float32).numpy()
        if t.dtype == torch.bfloat16:
            gap = np.abs(got - want)
            assert (gap <= BF16_REL * np.maximum(np.abs(got), np.abs(want))).all(), (
                what, gap.max())
        else:
            np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-12, err_msg=what)


@pytest.mark.parametrize("name,ref_sched,port_sched", [
    ("constant", ref.constant_schedule(3e-4), optim.constant_schedule(3e-4)),
    ("cosine", ref.cosine_schedule(0.1, 150, 0.05), optim.cosine_schedule(0.1, 150, 0.05)),
    ("warmup_cosine", ref.warmup_cosine(1e-3, 10, 110), optim.warmup_cosine(1e-3, 10, 110)),
    ("warmup_cosine_no_warmup", ref.warmup_cosine(0.5, 0, 50),
     optim.warmup_cosine(0.5, 0, 50)),
])
def test_schedules_match_reference(name, ref_sched, port_sched):
    steps = np.arange(0, 201, dtype=np.int32)
    want = np.asarray([float(ref_sched(jnp.int32(s))) for s in steps], np.float32)
    got = np.asarray([port_sched(torch.tensor(int(s), dtype=torch.int32)).item()
                      for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-12, err_msg=name)
    assert port_sched(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("name,ref_opt,port_opt", [
    ("sgd", ref.sgd(0.05), optim.sgd(0.05)),
    ("sgd_momentum", ref.sgd(ref.cosine_schedule(0.05, 20), momentum=0.9),
     optim.sgd(optim.cosine_schedule(0.05, 20), momentum=0.9)),
    ("adamw", ref.adamw(ref.warmup_cosine(1e-2, 5, 20)),
     optim.adamw(optim.warmup_cosine(1e-2, 5, 20))),
    ("adamw_weight_decay", ref.adamw(3e-3, weight_decay=0.1),
     optim.adamw(3e-3, weight_decay=0.1)),
])
def test_optimizers_match_reference(name, ref_opt, port_opt):
    rng = np.random.default_rng(7)
    jp, tp = _trees(_draw(rng))
    js, ts = ref_opt.init(jp), port_opt.init(tp)
    assert ts["step"].dtype == torch.int32
    if "m" in ts:
        assert all(m.dtype == torch.float32 for m in optim.tree_leaves(ts["m"]))
    for i in range(20):
        jg, tg = _trees(_draw(rng, scale=0.5))
        ju, js = ref_opt.update(jg, js, jp)
        tu, ts = port_opt.update(tg, ts, tp)
        _assert_close(ju, tu, f"{name} step {i} updates")
        for key in ("m", "v", "mu"):
            if key in js:
                _assert_close(js[key], ts[key], f"{name} step {i} {key}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        optim.apply_updates(tp, tu)
        _assert_close(jp, tp, f"{name} step {i} params")


@pytest.mark.parametrize("max_norm", ["at", "past", "below"])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    arrays = _draw(rng)
    jg, tg = _trees(arrays)
    norm = float(np.sqrt(sum(np.sum(np.asarray(j.astype(jnp.float32)) ** 2)
                             for j in jax.tree.leaves(jg))))
    limit = {"at": norm, "past": norm / 4, "below": norm * 4}[max_norm]
    jc, jn = ref.clip_by_global_norm(jg, limit)
    tc, tn = optim.clip_by_global_norm(tg, limit)
    assert tn.dtype == torch.float32 and tn.dim() == 0
    np.testing.assert_allclose(float(tn), float(jn), rtol=F32_RTOL)
    _assert_close(jc, tc, f"clip {max_norm}")
    total = float(torch.sqrt(sum(torch.sum(x.float() ** 2) for x in optim.tree_leaves(tc))))
    assert total == pytest.approx(min(limit, norm), rel=1e-2)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in optim.tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


def test_sgd_and_adamw_minimize_quadratic():
    """The reference's quadratic-minimisation test, mirrored."""
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for opt in (optim.sgd(0.1), optim.sgd(0.05, momentum=0.9), optim.adamw(0.2)):
        params = {"w": torch.zeros(3, requires_grad=True)}
        state = opt.init(params)
        for _ in range(200):
            (g,) = torch.autograd.grad(loss(params), [params["w"]])
            upd, state = opt.update({"w": g}, state, params)
            optim.apply_updates(params, upd)
        assert float(loss(params).detach()) < 1e-2


def test_schedule_runs_on_the_step_device():
    sched = optim.warmup_cosine(1.0, warmup=10, total_steps=110)
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(sched(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0, abs=1e-5)
    state = optim.adamw(sched).init({"w": torch.zeros(2, device="meta")})
    assert state["step"].device.type == "meta"
    assert state["m"]["w"].dtype == torch.float32
