"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit); a run prints the card's
``power.limit`` beside any share of them."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12  # outside the tensor cores (an f32 trunk with TF32 off)
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

# the dense peak of the precision a trunk computes in
TRUNK_PEAK = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}
