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


def _tp_cases():
    """(arch, m) of every arch at every model axis above 1: the documented
    departures (:func:`_documented_layout`) where m does not divide a
    dim."""
    return [(arch, m) for arch in ARCHS for m in MODEL_SIZES[1:]]


def _documented_layout(cfg, plan, m, path, spec_layout):
    """The port's layout of a leaf, (dim, parts, sections), where it departs
    from the reference's spec, else the spec's (``spec_layout``):

      * an attention block whose query heads m does not divide: whole
        (replicated; the spec splits ``wq`` inside a head);
      * a KV head held whole on the m / Hkv ranks whose query heads read it
        (Hkv pieces);
      * MLA's ``w_dkv`` whole (the spec cuts its 576 columns across the
        latent and the rope key; ``kv_norm`` reads the latent whole);
      * Mamba2 by heads: ``in_proj`` by sections [z, x by heads, B, C
        whole, dt by heads] (the spec cuts the concatenation straight
        across), ``conv_w``/``conv_b`` [x by heads, B, C whole] and
        ``A_log``, ``dt_bias``, ``D``, ``out_norm`` by heads (the spec
        replicates them);
      * the mLSTM by heads: ``up`` [x_inner whole, z by heads] (the spec
        cuts across), ``w_if`` (and its bias, which the spec replicates)
        [i, f] by heads, ``out_norm`` by heads; where m does not divide the
        heads, the mLSTM whole (the spec splits ``up``, ``wq``/``wk``/``wv``
        inside a head and ``down``'s rows);
      * the sLSTM whole (the spec splits ``down``'s rows): its recurrence
        couples every head."""
    parts = path.split("/")
    leaf = parts[-2] if parts[-1] in ("w", "b", "scale") else parts[-1]
    kind = plan[int(parts[1])].kind if parts[0] == "stacks" else "enc"
    if kind in ("mamba", "mlstm", "slstm"):
        di, h = 2 * cfg.d_model, (2 * cfg.d_model // 64 if kind == "mamba" else cfg.n_heads)
        if kind == "slstm" or h % m:
            return None
        if kind == "mamba":
            xbc = ((di, True), (cfg.ssm_state, False), (cfg.ssm_state, False))
            sections = {"in_proj": ((di, True),) + xbc + ((h, True),), "conv_w": xbc,
                        "conv_b": xbc}
            if leaf in sections:
                return (-1, m, sections[leaf])
            if leaf in ("A_log", "dt_bias", "D", "out_norm"):
                return (-1, m, None)
        else:
            sections = {"up": ((di, False), (di, True)), "w_if": ((h, True), (h, True))}
            if leaf in sections:
                return (-1, m, sections[leaf])
            if leaf == "out_norm":
                return (-1, m, None)
        return spec_layout
    attn = any(a in parts for a in ("attn", "self_attn", "cross_attn"))
    if attn and cfg.n_heads % m:
        return None
    if attn and leaf == "w_dkv":
        return None
    if attn and not cfg.kv_lora_rank and leaf in ("wk", "wv") and cfg.n_kv_heads % m:
        return (-1, cfg.n_kv_heads, None)
    return spec_layout


def _leaves(model):
    """{reference path: parameter} of a port ``Model``: each stack's first
    layer, and an encoder-decoder's encoder."""
    leaves = {"embed": model.embedding, "final_norm/scale": model.final_norm.scale,
              "head/w": model.head.w}
    stacks = [(f"stacks/{i}", stack) for i, stack in enumerate(model.stacks)]
    if model.encoder is not None:
        stacks.append(("encoder/stacks/0", model.encoder.stacks[0]))
        leaves["encoder/norm/scale"] = model.encoder.norm.scale
    for prefix, stack in stacks:
        for name, p in stack.layers[0].named_parameters():
            leaves[f"{prefix}/{name.replace('.', '/')}"] = p
    return leaves


@pytest.mark.parametrize("arch,m", _tp_cases())
def test_parallel_layout_is_the_param_shardings_spec(arch, m):
    """Each parameter's recorded layout (``parallel.mark``: what
    ``shard_params``/``gather_params`` read) puts the model axis on the dim
    ``param_shardings``' spec gives it, in m contiguous pieces, and a
    replicated leaf is replicated in both, leaf for leaf, but for the
    documented departures (:func:`_documented_layout`)."""
    from repro_torch.models.parallel import layout
    cfg = get_config(arch)
    plan = build_plan(cfg)
    mesh = tmesh.abstract_mesh((1, m), ("data", "model"))
    model = Model(cfg, plan, META, par=mesh.parallel())
    specs = tsh.param_shardings(model, mesh)
    leaves = _leaves(model)
    assert sorted(leaves) == sorted(specs)
    for path, p in leaves.items():
        spec = specs[path]
        want = _documented_layout(
            cfg, plan, m, path,
            (spec.index("model") - len(spec), m, None) if "model" in spec else None)
        lay = layout(p)
        assert (lay and (lay.dim, lay.parts, lay.sections)) == want, path


def test_sectioned_layout_cuts_each_section():
    """``shard_param`` cuts each section of a sectioned leaf (a split
    section in m pieces, a whole one as it is) and ``whole_shape`` gives
    the whole leaf back: Mamba2's ``in_proj`` at m 4, piece by piece equal
    to the reference's sections cut by heads."""
    from repro_torch.models import parallel
    whole = torch.arange(2 * 22, dtype=torch.float32).view(2, 22)  # [z 8, x 8, B 2, C 2, dt 2]
    sections = ((8, True), (8, True), (2, False), (2, False), (2, True))
    got = []
    for r in range(2):
        p = torch.empty((2, 4 + 4 + 2 + 2 + 1))
        parallel.mark(p, -1, 2, r, sections)
        tsh.shard_param(p, whole)
        assert tsh.whole_shape(p) == (2, 22)
        got.append(p)
        z, x, b, c, dt = whole.split([8, 8, 2, 2, 2], dim=-1)
        want = torch.cat([z[:, 4 * r:4 * r + 4], x[:, 4 * r:4 * r + 4], b, c, dt[:, r:r + 1]],
                         dim=-1)
        assert torch.equal(p, want)


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
    """(arch, shape, multi_pod) of every arch's decode shapes on both
    production meshes."""
    from repro_torch.launch.shapes import applicable
    return [(arch, shape, multi) for arch in ARCHS
            for shape in ("decode_32k", "long_500k") if applicable(arch, shape)[0]
            for multi in (False, True)]


@pytest.mark.parametrize("arch,shape,multi", _cache_cells())
def test_sequence_sharded_cache_holds_the_reference_spec_bytes(arch, shape, multi):
    """A rank's decode cache on the abstract production mesh against
    ``local_bytes`` of the reference's spec (``cache_shardings`` with
    ``seq_shard`` at a batch of 1, as the reference's ``input_specs``),
    leaf by leaf: equal where the model ranks that share a KV head (or
    MLA's latent, which has no head axis) split its sequence (the spec's
    ``model`` on the sequence, ``decode_32k``), no more where the data
    ranks split it too (``long_500k``: the spec replicates the KV heads
    over ``model``, the port keeps a rank's own).  Two documented
    departures: Mamba2's convolution inputs hold the rank's x channels and
    the whole B and C (the spec replicates them over ``model``: fewer
    bytes), and the sLSTM's state is whole on each model rank (the spec
    splits its d over ``model``)."""
    from repro_torch.launch.mesh import PRODUCTION
    from repro_torch.launch.steps import SHAPES, apply_shape_settings
    sh = SHAPES[shape]
    cfg = apply_shape_settings(get_config(arch), sh)
    dims, axes = PRODUCTION[multi]
    mesh = tmesh.abstract_mesh(dims, axes)
    seq_shard = sh.global_batch == 1
    plan = build_plan(cfg)
    cache = Model(cfg, plan, META, mesh.parallel()).init_cache(
        sh.global_batch, sh.seq_len, seq_shard)
    whole = Model(cfg, plan, META).init_cache(sh.global_batch, sh.seq_len)
    specs = tsh.cache_shardings(whole, mesh, sh.global_batch, seq_shard)
    assert cache.panels.rows_whole == seq_shard
    attention = ("k", "v", "latent", "k_rope")
    if seq_shard:
        # the reference's layout: the attention caches' sequence over the data axes
        data = tuple(a for a in axes if a != "model")
        seq = {name: spec[len(spec) - (2 if name.endswith(("latent", "k_rope")) else 3)]
               for name, spec in specs.items() if name.split("/")[-1] in attention}
        assert set(seq.values()) <= {data if len(data) > 1 else data[0]}, seq
    for i, (sp, c, w) in enumerate(zip(plan, cache, whole)):
        for name, t in w.items():
            want = tsh.local_bytes(t.shape, t.element_size(), specs[f"{i}/{name}"], mesh)
            got = c[name].numel() * c[name].element_size()
            what = (arch, shape, multi, f"{i}/{name}", got, want)
            if sp.kind == "mamba" and name == "conv":
                assert got < want, what
            elif sp.kind == "slstm":
                whole_over_model = tuple(None if a == "model" else a
                                         for a in specs[f"{i}/{name}"])
                assert got == tsh.local_bytes(t.shape, t.element_size(), whole_over_model,
                                              mesh), what
            elif seq_shard and name in attention:
                assert got <= want, what
            else:
                assert got == want, what


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
