"""PPO + tactile-only MAE with frozen-DINO vision, on the card (counterpart of
``m3l_tpu/cli/train_dino_tac_mae.py``): ``cli/train_dino_cat_mae.py`` with ``--tactile_only_mae
True``, so the MAE embeds and reconstructs the tactile maps only (50 tokens, 10 kept at mask 0.8).
"""
from __future__ import annotations

import sys

from .train_dino_cat_mae import build_model  # noqa: F401 (the cat CLI's model, built with this parser's config)
from .train_dino_cat_mae import build_parser as _cat_parser
from .train_dino_cat_mae import main as _cat_main


def build_parser():
    parser = _cat_parser()
    parser.set_defaults(tactile_only_mae=True)
    return parser


def main(argv: list[str] | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--tactile_only_mae" not in " ".join(argv):
        argv += ["--tactile_only_mae", "True"]
    return _cat_main(argv)


if __name__ == "__main__":
    main()
