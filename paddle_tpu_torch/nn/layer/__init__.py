"""Layers of the port (counterpart of ``paddle_tpu.nn.layer``)."""
