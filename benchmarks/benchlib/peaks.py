"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). The models here run float32 with TF32 off, so
their operations are held to the CUDA cores' float32 rate."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
