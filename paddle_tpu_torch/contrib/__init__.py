"""Contrib toolkits: the port of ``paddle_tpu/contrib``. Only ``quant``
(quantization-aware training, calibration, the int8 freeze) is ported; the
other contrib modules (decoder, slim, nas, model_stat, op_frequence,
extend_optimizer, layers, reader, trainer, utils) are ROADMAP queue 1
item 10."""

from paddle_tpu_torch.contrib import quant

__all__ = ["quant"]
