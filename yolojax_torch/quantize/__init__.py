"""int8 post-training quantization (``quantize/ptq.py``) and
quantization-aware fine-tuning (``quantize/qat.py``)."""

from yolojax_torch.quantize.ptq import (  # noqa: F401
    QuantizedModel,
    apply_int8,
    calibrate,
    quantize_model,
)
