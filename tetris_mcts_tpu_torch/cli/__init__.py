"""Shared CLI helpers: the per-net default checkpoint paths."""

from tetris_mcts_tpu_torch.train.trainer import (DEFAULT_CKPT, DIST_DEFAULT_CKPT,
                                                 DQN_DEFAULT_CKPT, ENS_DEFAULT_CKPT,
                                                 VP_DEFAULT_CKPT)

_CKPT_BY_KIND = {"vv": DEFAULT_CKPT, "vp": VP_DEFAULT_CKPT, "dist": DIST_DEFAULT_CKPT,
                 "dqn": DQN_DEFAULT_CKPT, "ens": ENS_DEFAULT_CKPT}


def resolve_ckpt(args_ckpt: str, kind: str) -> str:
    """The checkpoint path of the `kind` net ("vv", "vp", "dist", "dqn" or
    "ens", the VV ensemble). Nets of different kinds never share a file: an explicit
    --checkpoint wins, and only the shared default (the VV net's) is
    redirected to the kind's own."""
    if args_ckpt != DEFAULT_CKPT:
        return args_ckpt
    return _CKPT_BY_KIND[kind]
