"""Where the card's and the CPU's float32 normals can differ.

Runs jax.random.normal's transform (threefry.uniform_f32, then erf_inv) on
the same Threefry words on the card and on the CPU, and counts, for each
intermediate, the words whose bits differ between the two devices; for the
float32 square root it also counts each device's words that differ from
numpy's correctly rounded float32 sqrt of the same input.  Needs one CUDA
device; the words are drawn on the CPU, so no kernel is built.

    python3 tools/erf_inv_card_cpu.py [--seeds 8] [--log2-words 20]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heongpu_tpu_torch.utils import threefry as tf  # noqa: E402


def stages(words, dev):
    """{stage: its float tensor on the CPU} of the normal transform on `dev`."""
    u = tf.uniform_f32(words.to(dev), tf.NORMAL_LO, 1.0)
    y = u * -u
    w = -torch.log1p(y.to(torch.float64)).to(torch.float32)
    out = {"u": u, "y": y, "log1p_f64": torch.log1p(y.to(torch.float64)),
           "log1p_f32": torch.log1p(y), "w": w, "sqrt_f32": torch.sqrt(w),
           "sqrt_via_f64": torch.sqrt(w.to(torch.float64)).to(torch.float32),
           "normal": tf._f32(float(np.float32(np.sqrt(2))), dev) * tf.erf_inv(u)}
    return {k: v.cpu() for k, v in out.items()}


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--log2-words", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    differ, not_ieee = {}, {"card": 0, "cpu": 0}
    for seed in range(a.seeds):
        words = tf.bits32_plain(tf.key_from_seed(1234 + seed), (1 << a.log2_words,), "cpu")
        c, g = stages(words, "cpu"), stages(words, "cuda")
        for k in c:
            differ[k] = differ.get(k, 0) + int((bits(c[k]) != bits(g[k])).sum())
        exact = torch.from_numpy(np.sqrt(c["w"].numpy()))
        not_ieee["cpu"] += int((bits(c["sqrt_f32"]) != bits(exact)).sum())
        not_ieee["card"] += int((bits(g["sqrt_f32"]) != bits(exact)).sum())
    print(f"{a.seeds} x 2^{a.log2_words} words; card and CPU differ in: {differ}")
    print(f"float32 torch.sqrt words off numpy's correctly rounded sqrt: {not_ieee}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
