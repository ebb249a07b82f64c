"""Device-loss classification and the device probe (PyTorch port of
``kubernetes_tpu/parallel``). The mesh and the node-axis sharded kernels
are ROADMAP queue 1 item 8."""
