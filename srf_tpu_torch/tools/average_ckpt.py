"""CLI: average the last N checkpoints into ``$ckpt/avg`` (port of
``srf_tpu/tools/average_ckpt.py``; every model family of
``models/registry.py``).

Reference parity: tfsr/utils/average_ckpt_sr.py — same flags as the
trainers, averages the last ``--model-average-num`` checkpoints (filtered
to step <= --train-max-epoch when > 0) and writes ``$ckpt/avg/1``. The
averaged weights are loaded into the model the flags describe before they
are saved, so flags that do not match the checkpoints fail here.

Usage:
    python -m srf_tpu_torch.tools.average_ckpt --config=... --path-ckpt=... \\
        --model-average-num=10
"""

import sys

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.utils.checkpoint import CheckpointManager, average_checkpoints
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab


def main(argv=None):
    logger = Logger(name="average_ckpt", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args

    _, _, dec_in_dim, _ = load_vocab(
        get_file_path(config.path_base, config.path_vocab), logger
    )
    dec_out_dim = dec_in_dim + 1
    logger.info("The modified output Dimension %d", dec_out_dim)

    if not config.model_average_num or config.model_average_num < 1:
        raise SystemExit(
            "--model-average-num must be a positive checkpoint count "
            "(got %r)" % (config.model_average_num,)
        )
    from srf_tpu_torch.models.registry import build_model

    model, _ = build_model(config, dec_out_dim, logger)
    avg_state, steps = average_checkpoints(
        config.path_ckpt, config.model_average_num,
        max_epoch=config.train_max_epoch or 0, logger=logger,
    )
    model.load_state_dict(avg_state["model"])  # strict: flags must match
    logger.info("Total %d checkpoints were averaged.", len(steps))

    manager = CheckpointManager(config.path_ckpt + "/avg", max_to_keep=1)
    path = manager.save(1, avg_state)
    manager.close()
    logger.info("Saved to %s", path)


if __name__ == "__main__":
    main()
