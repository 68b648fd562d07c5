"""Loss and statistics ops of the port (``edrl_tpu.ops`` counterparts)."""
