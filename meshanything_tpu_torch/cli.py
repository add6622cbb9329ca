"""CLI of the PyTorch port, with the reference's flags for the main path
(main.py:60-89) and the JAX CLI's:

    python -m meshanything_tpu_torch.cli --input_path pc.npy --input_type pc_normal
    python main_torch.py --input_path pc.npy --input_type pc_normal    # the same

reads the reference checkpoint ``--pretrained_weights`` (default
``MeshAnything_350m.pth``: a safetensors file, converted as JAX converts
it; a directory is a checkpoint of the port's own, ``save_native``), or
seeded random weights with ``--random_weights``, and writes
``<out_dir>/<time>/<uid>_gen.obj``. ``--device cuda`` (the default) needs
a card and never falls back to the CPU.

The fast tier: ``--attn pallas_int8|pallas_int4`` (quantized KV cache),
``--lookahead N|adaptive`` (Jacobi windows), ``--wq`` (int8 W8A8 layer
matrices), and ``--fast``, which means ``--wq --attn pallas_int8
--lookahead 8`` with an explicit ``--attn``/``--lookahead`` winning over
the preset. ``--mc`` watertights mesh inputs through the distance field
and marching tetrahedra first; ``--complete_from`` continues the faces of
a partial mesh (mesh completion). ``--metrics_out`` writes the records one
JSON object a line, ``--resume`` skips inputs whose OBJ exists,
``--aot_dir`` keeps the built kernel libraries in a directory that a
later process finds them in (``runtime/aot.py``), and ``--precompile``
builds them and captures the batch size's decode graphs before the first
input (with no input, it only does that). ``--multihost`` runs a folder
over the ranks of ``torchrun --nproc_per_node N -m
meshanything_tpu_torch.cli --multihost ...``: the inputs are split per
rank (``parallel/multihost.py``; each rank draws the seeded sampling over
every input, so the outputs equal one process's), each rank decodes on its card (``cuda:
LOCAL_RANK % device_count()``) with no collective, all write into one
``<out_dir>/<time>``, and ``--metrics_out`` gets a ``.{rank}`` suffix on
ranks > 0; on one process it is a no-op. ``--attn xla`` is not ported and
raises. As in the JAX CLI,
``--attn megakernel`` is no choice: ``InferencePipeline(attn="megakernel")``
is that path's entry. ``python -m meshanything_tpu_torch.serving`` takes
the same flags and serves over HTTP.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time


def get_args(argv=None):
    parser = argparse.ArgumentParser("MeshAnything (PyTorch port)")
    # the reference's name of the language model: accepted and recorded, as in
    # the JAX CLI; the decoder's shape comes from the config
    parser.add_argument("--llm", default="facebook/opt-350m", type=str)
    parser.add_argument("--input_dir", default=None, type=str)
    parser.add_argument("--input_path", default=None, type=str)
    parser.add_argument("--out_dir", default="inference_out", type=str)
    parser.add_argument("--input_type", choices=["mesh", "pc_normal"], default="pc")
    parser.add_argument("--codebook_size", default=8192, type=int)
    parser.add_argument("--codebook_dim", default=1024, type=int)
    parser.add_argument("--n_max_triangles", default=800, type=int)
    parser.add_argument("--batchsize_per_gpu", default=1, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--sampling", default=False, action="store_true")
    parser.add_argument("--random_weights", default=False, action="store_true",
                        help="seeded random weights (--seed) instead of a checkpoint")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--bucket", default=512, type=int,
                        help="the KV cache length is padded to a multiple of this")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--lookahead", default=0,
                        type=lambda v: v if v == "adaptive" else int(v),
                        help="Jacobi lookahead window; 'adaptive' switches between 8 and 16 "
                             "on measured acceptance")
    # the JAX CLI's choices: "megakernel" is no CLI choice there either; its
    # entry is InferencePipeline(attn="megakernel")
    parser.add_argument("--attn", default="auto",
                        choices=["auto", "pallas", "pallas_int8", "pallas_int4", "xla"],
                        help="decode cache tier: auto (= pallas), pallas, pallas_int8, "
                             "pallas_int4 (xla: not ported)")
    parser.add_argument("--wq", default=False, action="store_true",
                        help="int8 W8A8 decode-loop weights (prefill and lm_head stay)")
    parser.add_argument("--fast", default=False, action="store_true",
                        help="preset: --wq --attn pallas_int8 --lookahead 8; an explicit "
                             "--attn/--lookahead wins over the preset")
    parser.add_argument("--mc", default=False, action="store_true",
                        help="watertight mesh inputs (distance field + marching tetrahedra) "
                             "before sampling")
    parser.add_argument("--complete_from", default=None, type=str,
                        help="partial mesh (model output space [-0.5, 0.5)) whose faces seed "
                             "the decoder: mesh completion")
    parser.add_argument("--pretrained_weights", default="MeshAnything_350m.pth", type=str,
                        help="the reference checkpoint (safetensors), or a directory of the "
                             "port's own checkpoint (save_native)")
    parser.add_argument("--metrics_out", default=None, type=str,
                        help="write the result records here, one JSON object a line")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="skip inputs whose output OBJ already exists")
    parser.add_argument("--aot_dir", default=None, type=str,
                        help="directory of built kernel libraries (runtime/aot.py): a later "
                             "process finds them there instead of running nvcc")
    parser.add_argument("--precompile", default=False, action="store_true",
                        help="build the kernel libraries and capture the batch size's decode "
                             "graphs before the first input (no input needed)")
    parser.add_argument("--multihost", default=False, action="store_true",
                        help="split the inputs over the ranks of torchrun (one process: "
                             "no-op)")
    return apply_fast_preset(parser.parse_args(argv))


def apply_fast_preset(args):
    """Resolve --fast into its knobs (JAX cli.py:85-98): int8 cache
    unless --attn was given, lookahead 8 unless --lookahead was given,
    and int8 weights."""
    if args.fast:
        if args.attn == "auto":
            args.attn = "pallas_int8"
        if args.lookahead == 0:
            args.lookahead = 8
        args.wq = True
    return args


def check_ported(args) -> None:
    """Raise on flags whose code is not ported yet."""
    later = {
        "--attn": args.attn not in ("auto", "pallas", "pallas_int8", "pallas_int4"),
    }
    named = [flag for flag, given in later.items() if given]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: not ported yet to meshanything_tpu_torch (it runs the "
            "exact and the fast tiers of the decode on one card: --attn "
            "pallas|pallas_int8|pallas_int4, --lookahead, --wq, --fast; --mc, "
            "--complete_from, --multihost)")


def build_config(args):
    """The config of the flags (JAX cli.py:101-112): the codebook from
    --codebook_size / --codebook_dim, the vocabulary the codebook plus bos,
    eos and pad."""
    from meshanything_tpu_torch.config import MeshAnythingConfig, ShapeOPTConfig

    return MeshAnythingConfig(
        opt=ShapeOPTConfig(codebook_size=args.codebook_size, codebook_dim=args.codebook_dim,
                           vocab_size=args.codebook_size + 3),
        n_max_triangles=args.n_max_triangles, dtype=args.dtype)


def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (no fallback to the CPU)")
    return device


def load_params(args, cfg, device):
    """The model on ``device`` in ``--dtype`` (JAX cli.py:115-140): seeded
    random weights (``--random_weights``), the port's own checkpoint (a
    directory) or the reference checkpoint (a file)."""
    import torch

    from meshanything_tpu_torch.runtime import checkpoint as ckpt

    dtype = cfg.activation_dtype
    if args.random_weights:
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
        print(f"using random weights (--random_weights, seed {args.seed})")
        return ckpt.init_random_params(cfg, generator, dtype)
    path = args.pretrained_weights
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path!r} not found. Download MeshAnything_350m.pth "
            "from the HF hub (Yiwen-ntu/MeshAnything) and pass "
            "--pretrained_weights, or use --random_weights for a smoke run."
        )
    if os.path.isdir(path):
        return ckpt.load_native(path, cfg, device=device, dtype=dtype)
    model = ckpt.load_reference_checkpoint(path, cfg, device=device, dtype=dtype)
    print("converted reference checkpoint:", path)
    return model


def collect_inputs(args):
    """The input files (JAX cli.py:143-156): a folder's ``.npy`` files for
    pc_normal, its ``.ply .obj .npy .stl .off .glb`` files for meshes;
    with ``--precompile`` and no input, none."""
    if args.input_dir is not None:
        names = sorted(os.listdir(args.input_dir))
        if args.input_type == "pc_normal":
            names = [n for n in names if n.endswith(".npy")]
        else:
            names = [n for n in names
                     if n.endswith((".ply", ".obj", ".npy", ".stl", ".off", ".glb"))]
        return [os.path.join(args.input_dir, n) for n in names]
    if args.input_path is not None:
        return [args.input_path]
    if args.precompile:
        return []  # build and capture only
    raise ValueError("input_dir or input_path must be provided.")


def main(argv=None):
    from meshanything_tpu_torch.runtime.compile_cache import enable as enable_compile_cache
    from meshanything_tpu_torch.runtime.pipeline import (
        InferencePipeline,
        load_inputs,
        write_metrics,
    )

    enable_compile_cache()
    args = get_args(argv)
    check_ported(args)
    rank, world = 0, 1
    if args.multihost:
        from meshanything_tpu_torch.parallel import multihost

        multihost.initialize_multihost()
        rank, world = multihost.process_info()
        print(f"multihost: process {rank}/{world}")
        device = multihost.rank_device(args.device)
    else:
        device = resolve_device(args.device)
    cfg = build_config(args)

    stamp = datetime.datetime.now().strftime("%d_%H-%M-%S")
    if args.multihost:
        from meshanything_tpu_torch.parallel.collectives import broadcast_object

        stamp = broadcast_object(stamp)     # one folder for every rank
    out_dir = os.path.join(args.out_dir, stamp)
    os.makedirs(out_dir, exist_ok=True)

    model = load_params(args, cfg, device)
    paths = collect_inputs(args)
    samples = load_inputs(args.input_type, paths, marching_cubes=args.mc,
                          num_points=cfg.perceiver.num_points, seed=args.seed)
    if args.multihost:
        # the samples, not the paths, are split: the seeded sampling draws
        # over every input in order on each rank, so that an input's points,
        # and its mesh, do not depend on the number of ranks
        samples = multihost.shard_files_for_host(samples)
    print(f"dataset total data samples: {len(samples)}")

    prompt_tokens = None
    if args.complete_from:
        from meshanything_tpu_torch.geometry import load_mesh
        from meshanything_tpu_torch.models.meshanything import build_face_prompt

        partial = load_mesh(args.complete_from)
        face_coords = partial.vertices[partial.faces]          # (nf, 3, 3)
        prompt_tokens = build_face_prompt(cfg, face_coords[None])[0].numpy()
        print(f"mesh completion: seeding {len(partial.faces)} faces "
              f"({len(prompt_tokens)} tokens) from {args.complete_from}")

    # a rank past the first names its place in a budget error
    place = f"rank {rank} of {world} (--multihost)" if rank else None
    pipe = InferencePipeline(model, cfg, batch_size=args.batchsize_per_gpu, bucket=args.bucket,
                             attn=args.attn, lookahead=args.lookahead, wq=args.wq,
                             aot_dir=args.aot_dir, place=place)
    if args.precompile:
        t0 = time.time()
        report = pipe.runner.precompile(args.batchsize_per_gpu, sampling=args.sampling)
        where = f" (kernel libraries in {args.aot_dir})" if args.aot_dir else ""
        print(f"precompile done in {time.time() - t0:.1f}s: built {report['built']}, "
              f"{report['graph_captures']} decode graphs captured{where}")
        if not paths and not args.multihost:   # every rank goes on to the closing barrier
            return []
    begin = time.time()
    print("Generation Start!!!")
    results = pipe.run(samples, out_dir, sampling=args.sampling, seed=args.seed,
                       resume=args.resume, prompt_tokens=prompt_tokens)
    for r in results:
        print(f"{r.get('obj_path', r['uid'])} Over!!")
    print(f"Total time: {time.time() - begin}")
    if args.metrics_out:
        # one file a rank (JAX cli.py:245-246)
        write_metrics(results, f"{args.metrics_out}.{rank}" if rank else args.metrics_out)
    if args.multihost:
        multihost.finish_multihost()
    return results


if __name__ == "__main__":
    main()
