"""The trainer and evaluator (``edrl_tpu.train`` counterparts): the train and
eval steps and the fit loop, metrics, logging, checkpoints and plots."""
