"""int8 post-training quantization (``quantize/ptq.py``). Quantization-aware
training (yolojax's ``quantize/qat.py``) is not ported yet (ROADMAP queue 1,
item 9)."""

from yolojax_torch.quantize.ptq import (  # noqa: F401
    QuantizedModel,
    apply_int8,
    calibrate,
    quantize_model,
)
