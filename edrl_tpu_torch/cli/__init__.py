"""The command-line entry points (``edrl_tpu.cli`` counterparts): ``train``
and ``test``."""
