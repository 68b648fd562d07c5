"""A port CLI at the tiny config's model and input sizes, as a script that a
launcher can start: ``python -m torch.distributed.run --nproc_per_node 2
tests/torch_tiny_cli.py train|test <CLI arguments>``.  It patches
``cli.train.config_from_args`` as ``test_torch_cli.py``'s ``tiny_cli``
fixture does in-process, keeping ``--model_name``; every other setting is
the CLI's."""

import dataclasses
import sys

from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.cli import test as test_cli
from edrl_tpu_torch.cli import train as train_cli


def main(argv):
    real = train_cli.config_from_args

    def tiny(args):
        cfg = real(args)
        t = tconfig.tiny_test_config(batch_size=cfg.data.batch_size)
        data = dataclasses.replace(cfg.data, fundus_size=t.data.fundus_size, oct_size=t.data.oct_size)
        return cfg.replace(data=data, model=dataclasses.replace(t.model, use_bfloat16=cfg.model.use_bfloat16,
                                                                model_name=cfg.model.model_name))

    train_cli.config_from_args = tiny
    (test_cli if argv[0] == "test" else train_cli).main(argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
