"""Offline checkpoint splitter of the PyTorch port: a Hugging Face checkpoint
directory (``.safetensors`` or ``.bin``, indexed or single-file) into one
safetensors file per layer, as the JAX package's ``prepare_weights.py``
writes it, for the port's streamed CLI:

    python -m flexible_llm_sharding_tpu_torch.prepare_weights <hf_dir> <out_dir> \\
        [--dtype bfloat16|float16|float32] [--layout native|hf]

``--layout native`` (the default) stores linear kernels transposed to
[in, out] under the layer functions' names; ``--layout hf`` writes the
reference's own files, which the CLI converts as it loads them. A
multimodal wrapper checkpoint (Gemma 3) is split into its text tower.
Quantized dtypes and mixed-precision plans (``--precision_plan``) are not
ported yet (ROADMAP item 3.5).
"""

from __future__ import annotations

import argparse
import sys
import time

from flexible_llm_sharding_tpu_torch.utils.checkpoint import SPLIT_DTYPES, split_into_layers


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("bin_dir", help="Hugging Face checkpoint directory (.bin or .safetensors)")
    p.add_argument("new_file_dir", help="output directory for the per-layer files")
    p.add_argument("--dtype", default=None, choices=[k for k in SPLIT_DTYPES if k],
                   help="cast every float tensor at split time (default: keep the checkpoint's)")
    p.add_argument("--layout", default="native", choices=["native", "hf"])
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    layers = split_into_layers(args.bin_dir, args.new_file_dir, dtype=args.dtype, layout=args.layout,
                               progress=lambda name: print(name, file=sys.stderr))
    print(f"wrote {len(layers)} layer files to {args.new_file_dir} in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return layers


if __name__ == "__main__":
    main()
