"""The port's sharding rules (``launch/shardings.py``) against the
reference's (``repro/launch/shardings.py``) on the CPU, and B4's
vocab-parallel plain version against ``fused_xent_plain``.

  * For every arch of ``list_archs()`` at its full config (shapes only:
    ``jax.eval_shape`` of the reference's init, the port's model on the
    meta device), the reference's leaf paths and shapes equal the port's
    (``param_shapes``), and ``param_shardings``' spec of every leaf at
    ``model`` sizes 1, 2, 4 and 16, with and without a leading cluster dim,
    equals the reference's.  So do ``batch_shardings``,
    ``cache_shardings`` (with and without ``seq_shard``),
    ``pigeon_round_shardings`` and ``pigeon_sweep_shardings``.
  * ``make_production_mesh`` has the reference's shapes, ``data_axes`` its
    names; ``shard_params`` and ``gather_params`` (a group of one) round
    trip.
  * Each decode arch's ``init_cache`` at ``decode_32k`` and ``long_500k``
    on the abstract 16 x 16 and 2 x 16 x 16 meshes: a rank's bytes equal
    ``local_bytes`` of the reference's ``cache_shardings`` spec where the
    model ranks that share a KV head split its sequence, and no more where
    the data ranks split it too (a batch of 1, the reference's seq_shard).
  * ``vocab_parallel_xent_plain`` over m panels (labels in every panel) and
    the single-process ``VocabParallelXent`` equal ``fused_xent_plain`` on
    the whole head, forward and gradients.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import shardings as rsh
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import fused_xent as tfx
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model
from repro_torch.models.model import Model, build_plan
from _torch_threads import one_thread  # noqa: F401

MODEL_SIZES = (1, 2, 4, 16)
ARCHS = list_archs()


META = torch.device("meta")


def _meta_model(cfg):
    return Model(cfg, build_plan(cfg), META)


def _path(path) -> str:
    return rsh._path_str(path)


def _ref_leaves(tree):
    return {_path(p): tuple(x.shape) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_specs(shardings):
    return {_path(p): tuple(s.spec) for p, s in jax.tree_util.tree_leaves_with_path(shardings)}


def _norm(spec, ndim):
    """A spec padded with None to its tensor's rank (P drops nothing, but
    compare like for like)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def ref_shapes():
    """{arch: (param shapes, cache shapes)} of the reference's full configs."""
    out = {}
    for arch in ARCHS:
        jm = jbuild_model(jget_config(arch))
        params = _ref_leaves(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        cache = jax.eval_shape(lambda jm=jm: jm.init_cache(4, 64))
        out[arch] = (params, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), cache)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_paths_and_shapes_match_reference(ref_shapes, arch):
    model = _meta_model(get_config(arch))
    assert tsh.param_shapes(model) == ref_shapes[arch][0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m", MODEL_SIZES)
def test_param_shardings_match_reference(ref_shapes, arch, m):
    shapes, tree, _ = ref_shapes[arch]
    jmesh = AbstractMesh((1, m), ("data", "model"))
    mesh = tmesh.abstract_mesh(tuple(jmesh.shape.values()), jmesh.axis_names)
    model = _meta_model(get_config(arch))
    want = {k: _norm(v, len(shapes[k]))
            for k, v in _ref_specs(rsh.param_shardings(tree, jmesh)).items()}
    assert tsh.param_shardings(model, mesh) == want
    # a leading cluster dim over "pod"
    pmesh = AbstractMesh((2, 1, m), ("pod", "data", "model"))
    tpmesh = tmesh.abstract_mesh((2, 1, m), ("pod", "data", "model"))
    lead = jax.tree.map(lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), tree)
    want = {k: _norm(v, len(shapes[k]) + 1)
            for k, v in _ref_specs(rsh.param_shardings(lead, pmesh, cluster_axis="pod")).items()}
    got = tsh.param_shardings({k: (2,) + s for k, s in shapes.items()}, tpmesh,
                              cluster_axis="pod")
    assert got == want


def test_stacked_model_leaves_lead_with_the_slot_axis(ref_shapes):
    from repro_torch.models.model import StackedModel
    cfg = get_config("qwen3-moe-30b-a3b")
    stacked = StackedModel(cfg, build_plan(cfg), 2, META)
    assert tsh.param_shapes(stacked) == {k: (2,) + s
                                         for k, s in ref_shapes["qwen3-moe-30b-a3b"][0].items()}


def _gqa_archs():
    """The archs whose parallel model builds at a model axis > 1 (GQA,
    kinds ``attn_mlp``/``dense_mlp``/``moe``)."""
    return [arch for arch in ARCHS
            if not get_config(arch).kv_lora_rank and {sp.kind for sp in build_plan(
                get_config(arch))} <= {"attn_mlp", "dense_mlp", "moe"}]


#: the production cells whose layers the port holds whole where the
#: reference shards them: Qwen2.5-14B's attention (40 heads at 16: the
#: reference splits wq's 5,120 columns inside a head) and InternVL2-26B's
#: vocab (92,553 at 16: both replicate it), with its 8 KV heads each on 2
#: ranks
WHOLE_LAYER_CELLS = [("qwen2.5-14b", 16), ("internvl2-26b", 16)]


def _tp_cases():
    """(arch, m) of every GQA arch with m dividing its heads, KV heads and
    vocab, and :data:`WHOLE_LAYER_CELLS`."""
    cases = []
    for arch in _gqa_archs():
        cfg = get_config(arch)
        cases += [(arch, m) for m in MODEL_SIZES[1:]
                  if not (cfg.n_heads % m or cfg.n_kv_heads % m or cfg.vocab % m)]
    return cases + WHOLE_LAYER_CELLS


def _documented_layout(cfg, m, path, spec_layout):
    """The port's layout of a leaf where it departs from the spec: an
    attention block whose query heads m does not divide held whole
    (replicated); a KV head held whole on the m / Hkv ranks whose query
    heads read it (Hkv pieces); else the spec's."""
    if "/attn/" in path and cfg.n_heads % m:
        return None
    if "/attn/w" in path and path.split("/")[-2] in ("wk", "wv") and cfg.n_kv_heads % m:
        return (-1, cfg.n_kv_heads)
    return spec_layout


@pytest.mark.parametrize("arch,m", _tp_cases())
def test_parallel_layout_is_the_param_shardings_spec(arch, m):
    """Each parameter's recorded layout (``parallel.mark``: what
    ``shard_params``/``gather_params`` read) puts the model axis on the dim
    ``param_shardings``' spec gives it, in m pieces, and a replicated leaf
    is replicated in both, leaf for leaf, but for the documented whole
    layers and shared KV heads (:func:`_documented_layout`)."""
    from repro_torch.models.parallel import layout
    cfg = get_config(arch)
    mesh = tmesh.abstract_mesh((1, m), ("data", "model"))
    model = Model(cfg, build_plan(cfg), META, par=mesh.parallel())
    specs = tsh.param_shardings(model, mesh)
    leaves = {"embed": model.embedding, "final_norm/scale": model.final_norm.scale,
              "head/w": model.head.w}
    for i, stack in enumerate(model.stacks):
        for name, p in stack.layers[0].named_parameters():
            leaves[f"stacks/{i}/{name.replace('.', '/')}"] = p
    assert sorted(leaves) == sorted(specs)
    for path, p in leaves.items():
        spec = specs[path]
        want = _documented_layout(
            cfg, m, path, (spec.index("model") - len(spec), m) if "model" in spec else None)
        lay = layout(p)
        assert (lay and lay[:2]) == want, path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_cache_shardings_match_reference(ref_shapes, arch, seq_shard):
    _, _, cache = ref_shapes[arch]
    model = _meta_model(get_config(arch))
    port_cache = tsh.cache_paths(model.init_cache(4, 64))
    assert port_cache == _ref_leaves(cache)
    for dims, axes in (((16, 16), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
                       ((1, 2), ("data", "model")), ((4, 1), ("data", "model"))):
        jmesh = AbstractMesh(dims, axes)
        want = {k: _norm(v, len(port_cache[k])) for k, v in _ref_specs(
            rsh.cache_shardings(cache, jmesh, 4, seq_shard=seq_shard)).items()}
        assert tsh.cache_shardings(port_cache, tmesh.abstract_mesh(dims, axes), 4,
                                   seq_shard=seq_shard) == want, (dims, seq_shard)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_batch_and_round_shardings_match_reference(ref_shapes, shape):
    cfg, jcfg = get_config("qwen3-8b"), jget_config("qwen3-8b")
    jshape = JSHAPES[shape]
    for dims, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                       ((2, 2, 1), ("pod", "data", "model"))):
        jmesh, mesh = AbstractMesh(dims, axes), tmesh.abstract_mesh(dims, axes)
        jb = jsteps.batch_struct(jcfg, jshape)
        tb = tsteps.batch_struct(cfg, tsteps.SHAPES[shape])
        want = {k: _norm(v, len(jb[k].shape))
                for k, v in _ref_specs(rsh.batch_shardings(jb, jmesh)).items()}
        assert tsh.batch_shardings(tb, mesh) == want
        if "pod" not in axes:
            continue
        jbr = jsteps.batch_struct(jcfg, jshape, cluster_dim=2)
        tbr = tsteps.batch_struct(cfg, tsteps.SHAPES[shape], cluster_dim=2)
        _, tree, _ = ref_shapes["qwen3-8b"]
        lead = jax.tree.map(lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), tree)
        shapes = {k: (2,) + s for k, s in ref_shapes["qwen3-8b"][0].items()}
        jp, jbs, jv = rsh.pigeon_round_shardings(lead, jbr, jb, jmesh)
        tp, tbs, tv = tsh.pigeon_round_shardings(shapes, tbr, tb, mesh)
        assert tp == {k: _norm(v, len(shapes[k])) for k, v in _ref_specs(jp).items()}
        assert tbs == {k: _norm(v, len(jbr[k].shape)) for k, v in _ref_specs(jbs).items()}
        assert tv == {k: _norm(v, len(jb[k].shape)) for k, v in _ref_specs(jv).items()}
        sdims, saxes = (2,) + dims, ("seed",) + axes
        smesh, tsmesh = AbstractMesh(sdims, saxes), tmesh.abstract_mesh(sdims, saxes)
        jp, jbs, jv = rsh.pigeon_sweep_shardings(lead, jbr, jb, smesh)
        tp, tbs, tv = tsh.pigeon_sweep_shardings(shapes, tbr, tb, tsmesh)
        assert tp == {k: _norm(v, len(shapes[k])) for k, v in _ref_specs(jp).items()}
        assert tbs == {k: _norm(v, len(jbr[k].shape)) for k, v in _ref_specs(jbs).items()}
        assert tv == {k: _norm(v, len(jb[k].shape)) for k, v in _ref_specs(jv).items()}


def test_production_mesh_shapes_and_data_axes():
    from repro.launch.mesh import data_axes as jdata_axes
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    for mesh, dims, axes in ((single, (16, 16), ("data", "model")),
                             (multi, (2, 16, 16), ("pod", "data", "model"))):
        assert tmesh.data_axes(mesh) == jdata_axes(AbstractMesh(dims, axes))
    assert tsh.replicated(single) == ()
    with tmesh.group_of_one("gloo"):
        one = tmesh.make_production_mesh()
        assert one.shape == {"data": 1, "model": 1}
        assert one.parallel().trivial and one.pod_view().shape == {"pod": 1}
        with pytest.raises(ValueError, match="do not match"):
            tmesh.make_mesh((2, 2), ("data", "model"))


def test_fake_group_lays_the_production_mesh_over_512_ranks():
    with tmesh.fake_group(512):
        mesh = tmesh.make_production_mesh(multi_pod=True)
        par = mesh.parallel()
        assert (par.model_size, par.data_size, par.model_rank) == (16, 32, 0)
        assert par.data_axes == ("pod", "data")
        stacked = mesh.parallel("pod")
        assert (stacked.data_size, stacked.data_axes) == (16, ("data",))
        assert mesh.pod_view().shape == {"pod": 2}
    assert not torch.distributed.is_initialized()


def test_shard_and_gather_params_round_trip():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    whole = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with tmesh.group_of_one("gloo"):
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        model = tsh.shard_params(build_model(cfg, "cpu", mesh), dict(whole.named_parameters()))
        back = tsh.gather_params(model)
    for name, p in whole.named_parameters():
        assert torch.equal(back[name], p.detach()), name


def _cache_cells():
    """(arch, shape, multi_pod) of every GQA arch's decode shapes on both
    production meshes."""
    from repro_torch.launch.shapes import applicable
    return [(arch, shape, multi) for arch in _gqa_archs()
            for shape in ("decode_32k", "long_500k") if applicable(arch, shape)[0]
            for multi in (False, True)]


def _nbytes(cache) -> int:
    return sum(t.numel() * t.element_size() for c in cache for t in c.values())


@pytest.mark.parametrize("arch,shape,multi", _cache_cells())
def test_sequence_sharded_cache_holds_the_reference_spec_bytes(arch, shape, multi):
    """A rank's decode cache on the abstract production mesh against
    ``local_bytes`` of the reference's spec (``cache_shardings`` with
    ``seq_shard`` at a batch of 1, as the reference's ``input_specs``):
    equal where the model ranks that share a KV head split its sequence
    (the spec's ``model`` on the sequence, ``decode_32k``), no more where
    the data ranks split it too (``long_500k``: the spec replicates the KV
    heads over ``model``, the port keeps a rank's own)."""
    from repro_torch.launch.mesh import PRODUCTION
    from repro_torch.launch.steps import SHAPES, apply_shape_settings
    sh = SHAPES[shape]
    cfg = apply_shape_settings(get_config(arch), sh)
    dims, axes = PRODUCTION[multi]
    mesh = tmesh.abstract_mesh(dims, axes)
    seq_shard = sh.global_batch == 1
    cache = Model(cfg, build_plan(cfg), META, mesh.parallel()).init_cache(
        sh.global_batch, sh.seq_len, seq_shard)
    whole = Model(cfg, build_plan(cfg), META).init_cache(sh.global_batch, sh.seq_len)
    specs = tsh.cache_shardings(whole, mesh, sh.global_batch, seq_shard)
    want = sum(tsh.local_bytes(t.shape, t.element_size(), specs[name], mesh)
               for name, t in ((f"{i}/{k}", t) for i, c in enumerate(whole)
                               for k, t in c.items()))
    got = _nbytes(cache)
    assert cache.panels.rows_whole == seq_shard
    if seq_shard:
        # the reference's layout: the KV caches' sequence over the data axes
        data = tuple(a for a in axes if a != "model")
        assert {spec[2] for name, spec in specs.items() if name.endswith(("/k", "/v"))} == {
            data if len(data) > 1 else data[0]}
        assert got <= want
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_vocab_parallel_xent_plain_matches_the_whole_head(m):
    """Every rank's panel of a (D, V) head, labels in every panel: the
    combine over the panels (the plain version of what each rank's
    ``VocabParallelXent`` returns) equals B4's plain version on the whole
    head, and so do the gradients of one process's ranks, each through the
    panel's plain backward with the whole ``lse``."""
    rng = np.random.default_rng(m)
    t, d, v = 48, 16, 96
    h = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, v)).astype(np.float32))
    labels = torch.from_numpy(np.arange(t) * 7 % v)
    assert len(set((labels // (v // m)).tolist())) == m          # every panel has labels
    panels = list(w.chunk(m, dim=1))
    whole = tfx.fused_xent_plain(h, w, labels)
    got = tfx.vocab_parallel_xent_plain(h, panels, labels)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    # the backward: the plain panel backward with the whole lse, summed dh
    g = torch.from_numpy(rng.normal(size=(t,)).astype(np.float32))
    hw, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    dh_want, dw_want = torch.autograd.grad(tfx.fused_xent_plain(hw, ww, labels), (hw, ww), g)
    lse = torch.logsumexp(h @ w, dim=-1)
    dh, dws = torch.zeros_like(h), []
    for r, panel in enumerate(panels):
        dh_r, dw_r = tfx._panel_bwd_plain(h, panel, labels - r * (v // m), lse, g)
        dh += dh_r
        dws.append(dw_r)
    np.testing.assert_allclose(dh.numpy(), dh_want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat(dws, 1).numpy(), dw_want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_vocab_parallel_entry_on_a_group_of_one_is_fused_cross_entropy():
    """``ops.parallel_cross_entropy`` on a trivial view is B4's entry, bit
    for bit, masked or not."""
    from repro_torch.kernels import ops
    from repro_torch.models.parallel import SINGLE
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 40)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, (2, 8)))
    mask = torch.from_numpy(rng.integers(0, 2, (2, 8)))
    for mk in (None, mask):
        assert torch.equal(ops.parallel_cross_entropy(h, w, labels, mk, SINGLE),
                           ops.fused_cross_entropy(h, w, labels, mk))


def test_rule_table_is_the_reference_s():
    assert tsh._RULES == rsh._RULES
