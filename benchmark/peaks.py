"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense rates, at
the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "f32": 67e12,  # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bf16": 989e12,
    "int8": 1979e12,
}
# bytes of one intensity value in each precision the port sends
VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
