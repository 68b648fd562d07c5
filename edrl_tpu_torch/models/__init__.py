"""Model modules of the port (``edrl_tpu.models`` counterparts)."""
