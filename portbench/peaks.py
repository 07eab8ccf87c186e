"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit).  A run prints the card's own power limit beside
every share it reports against these."""

PEAK_FLOP_S = {
    "bfloat16": 989e12,  # tensor cores, dense
    "float32": 495e12,  # TF32 tensor cores, dense: the rate 3xTF32 kernels run on
}
PEAK_BYTES_S = 3.35e12  # HBM3
