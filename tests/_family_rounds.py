"""The sharded Pigeon-SL rounds of the xLSTM, Zamba2 and DeepSeek (MLA and
MoE) families, shared by ``tests/test_torch_family_rounds.py`` (the vmap
runs, in its process) and the ranks it spawns (the sharded runs): the
tiny configs of ``tests/test_torch_xlstm_round.py``,
``tests/test_torch_hybrid.py`` and ``tests/test_torch_moe_round.py``, one
task and protocol each.  Imports torch and the port only."""

#: family -> the tiny config (``ModelConfig`` fields)
FAMILIES = {
    "xlstm": dict(name="tiny-xlstm", arch_type="ssm", n_layers=4, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=0, vocab=64, slstm_every=2, ssm_chunk=16, cut_layer=2),
    "zamba2": dict(name="tiny-zamba2", arch_type="hybrid", n_layers=3, d_model=32, n_heads=2,
                   n_kv_heads=2, head_dim=16, d_ff=0, vocab=64, ssm_state=8, attn_every=2,
                   cut_layer=3),
    "deepseek": dict(name="tiny-mla-moe", arch_type="moe", n_layers=3, d_model=32, n_heads=2,
                     n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, kv_lora_rank=16,
                     rope_dim=8, n_experts=4, top_k=2, d_expert=16, n_shared_experts=1,
                     first_dense=1, cut_layer=2),
}
TASK = dict(vocab=64, seq_len=16, m_clients=2, d_m=32, d_o=16, n_test=16, seed=0)
#: M = 2 clients, N = 1: R = 2 clusters, one a rank of a group of 2
PCFG = dict(M=2, N=1, T=2, E=2, B=8, lr=5e-2, seed=0)


def run(family: str, placement: str):
    """``run_pigeon`` (batched engine, a label-flipping client 1) over
    ``from_lm`` of ``family``'s tiny model at ``placement``: its rounds."""
    import repro_torch.core as tcore
    from repro_torch.data import build_lm_task
    from repro_torch.models import ModelConfig, build_model
    module = tcore.from_lm(build_model(ModelConfig(**FAMILIES[family]), "cpu"))
    hist = tcore.run_pigeon(module, build_lm_task(**TASK), tcore.ProtocolConfig(**PCFG),
                            malicious={1}, attack=tcore.Attack("label_flip"),
                            engine="batched", placement=placement, device="cpu")
    return hist.rounds


def run_sharded(families, nice: int = 0):
    """Every family's sharded run on this rank, at niceness ``nice``."""
    import os
    os.nice(nice)
    return {f: run(f, "sharded") for f in families}
