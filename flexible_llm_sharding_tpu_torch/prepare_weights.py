"""Offline checkpoint splitter of the PyTorch port: a Hugging Face checkpoint
directory (``.safetensors`` or ``.bin``, indexed or single-file) into one
safetensors file per layer, as the JAX package's ``prepare_weights.py``
writes it, for the port's streamed CLI:

    python -m flexible_llm_sharding_tpu_torch.prepare_weights <hf_dir> <out_dir> \\
        [--dtype bfloat16|float16|float32|int8|int4] [--layout native|hf]
    python -m flexible_llm_sharding_tpu_torch.prepare_weights <native_dir> <out_dir> \\
        --precision_plan plan.json

``--layout native`` (the default) stores linear kernels transposed to
[in, out] under the layer functions' names; ``--layout hf`` writes the
reference's own files, which the CLI converts as it loads them. A
multimodal wrapper checkpoint (Gemma 3, Llama 4) is split into its text tower.
``--dtype int8`` quantizes every kernel per output channel (half the bf16
bytes over the link, dequantized on the card); ``int4`` in groups of 64
along the in axis, two values a byte (about 28% of the bf16 bytes).
``--precision_plan`` re-encodes an already split native float directory at
the plan's per-layer int4/int8/bf16 mix (build the plan with the
``plan-precision`` subcommand); it chooses every layer's dtype, so it
excludes ``--dtype``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from flexible_llm_sharding_tpu_torch.utils.checkpoint import (
    QUANT_DTYPES,
    SPLIT_DTYPES,
    requantize_native,
    split_into_layers,
)


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("bin_dir", help="Hugging Face checkpoint directory (.bin or .safetensors); with "
                                   "--precision_plan: a native float per-layer directory")
    p.add_argument("new_file_dir", help="output directory for the per-layer files")
    p.add_argument("--dtype", default=None,
                   choices=[k for k in SPLIT_DTYPES if k] + list(QUANT_DTYPES),
                   help="cast every float tensor at split time (default: keep the checkpoint's); "
                        "int8 = per-output-channel weight compression (half the host->device "
                        "bytes; dequantized on the card); int4 = group-wise packed nibbles (a "
                        "quarter of the bf16 bytes, plus scales)")
    p.add_argument("--layout", default="native", choices=["native", "hf"])
    p.add_argument("--precision_plan", default=None,
                   help="PrecisionPlan JSON (from the `plan-precision` subcommand): re-encode a "
                        "native float per-layer dir at a per-layer int4/int8/bf16 mix; the plan "
                        "is embedded in the output and every layer's dtype lands in the "
                        "integrity manifest")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    if args.precision_plan is not None:
        if args.dtype is not None:
            raise SystemExit("--precision_plan chooses each layer's dtype itself; drop --dtype")
        from flexible_llm_sharding_tpu_torch.runtime.precisionplan import PrecisionPlan

        with open(args.precision_plan) as f:
            plan = PrecisionPlan.from_json(json.load(f))
        layers = requantize_native(args.bin_dir, args.new_file_dir, plan=plan)
        print(f"wrote {len(layers)} mixed-precision layer files to {args.new_file_dir} in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return layers
    layers = split_into_layers(args.bin_dir, args.new_file_dir, dtype=args.dtype, layout=args.layout,
                               progress=lambda name: print(name, file=sys.stderr))
    print(f"wrote {len(layers)} layer files to {args.new_file_dir} in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return layers


if __name__ == "__main__":
    main()
