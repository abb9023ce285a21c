"""Split-learning core: the cut-layer exchange, validation, clustering, wire
accounting, the batched round runner and the Pigeon-SL drivers."""
from ..adversary import (ACTIVATION, BACKDOOR, GRAD_NOISE, GRAD_SCALE,
                         GRADIENT, HONEST, LABEL_FLIP, NONE, PARAM_TAMPER,
                         REPLAY, STEALTH, Attack)
from .clustering import cluster_is_honest, has_honest_cluster, make_clusters
from .comm import CommConfig, message_bytes, resolve_quant
from .protocol import (ClientData, CommMeter, History, ProtocolConfig,
                       evaluate, run_pigeon, run_pigeon_plus, run_pigeon_sweep,
                       run_splitfed, run_vanilla_sl, train_cluster)
from .runner import RoundRunner, RoundSpec, VerifyConfig
from .split import (SplitModule, client_update, client_update_stats, from_cnn,
                    from_lm, message_stats, sgd_update)
from .validation import check_handoff, handoff_activations, validation_loss

__all__ = [
    "ACTIVATION", "BACKDOOR", "GRAD_NOISE", "GRAD_SCALE", "GRADIENT", "HONEST",
    "LABEL_FLIP", "NONE", "PARAM_TAMPER", "REPLAY", "STEALTH", "Attack",
    "ClientData", "CommConfig", "CommMeter", "History", "ProtocolConfig",
    "SplitModule", "check_handoff", "client_update", "client_update_stats",
    "cluster_is_honest", "evaluate", "from_cnn", "from_lm", "handoff_activations",
    "has_honest_cluster", "make_clusters", "message_bytes", "message_stats",
    "resolve_quant", "run_pigeon", "run_pigeon_plus", "run_pigeon_sweep",
    "run_splitfed", "run_vanilla_sl", "sgd_update", "train_cluster",
    "validation_loss", "RoundRunner", "RoundSpec", "VerifyConfig",
]
