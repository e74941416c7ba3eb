"""The benchmark CLI (twin of ``mpi4dl_tpu/parser.py``, itself flag for
flag with the reference's ``torchgems/parser.py:21-143``): the same flags,
defaults and choices, plus ``--device`` (``cuda`` unless asked otherwise).
"""

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SP-MP-DP Configuration Script (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument(
        "-v",
        "--verbose",
        help="Prints performance numbers or logs",
        action="store_true",
    )
    parser.add_argument("--batch-size", type=int, default=32, help="input batch size")
    parser.add_argument(
        "--parts", type=int, default=1, help="Number of micro-batches per pipeline step"
    )
    parser.add_argument(
        "--split-size", type=int, default=2, help="Number of pipeline (LP) stages"
    )
    parser.add_argument(
        "--num-spatial-parts",
        type=str,
        default="4",
        help="Number of partitions in spatial parallelism (csv for multi-stage SP)",
    )
    parser.add_argument(
        "--spatial-size",
        type=int,
        default=1,
        help="Number of model stages that run spatially partitioned",
    )
    parser.add_argument(
        "--times",
        type=int,
        default=1,
        help="GEMS-MASTER replication factor (1: 2 replications, 2: 4 replications)",
    )
    parser.add_argument(
        "--image-size", type=int, default=32, help="Image size for synthetic benchmark"
    )
    parser.add_argument("--num-epochs", type=int, default=1, help="Number of epochs")
    parser.add_argument(
        "--num-layers", type=int, default=18, help="Number of layers in amoebanet"
    )
    parser.add_argument(
        "--num-filters", type=int, default=416, help="Number of filters in amoebanet"
    )
    parser.add_argument("--num-classes", type=int, default=10, help="Number of classes")
    parser.add_argument(
        "--balance",
        type=str,
        default=None,
        help="csv; length equals number of partitions, sum equals num layers",
    )
    parser.add_argument(
        "--halo-D2",
        dest="halo_d2",
        action="store_true",
        default=False,
        help="Enable design2 (one wide halo exchange amortized over fused convs)",
    )
    parser.add_argument(
        "--fused-layers",
        type=int,
        default=1,
        help="With --halo-D2, number of blocks sharing one halo exchange",
    )
    parser.add_argument(
        "--local-DP",
        type=int,
        default=1,
        help="LBANN-style local data parallelism inside the LP stages after SP",
    )
    parser.add_argument(
        "--slice-method",
        type=str,
        default="square",
        help="Slice method (square, vertical, and horizontal) in Spatial parallelism",
    )
    parser.add_argument(
        "--app",
        type=int,
        default=3,
        help="Application type (1.medical, 2.cifar, 3.synthetic)",
    )
    parser.add_argument(
        "--datapath",
        type=str,
        default="./train",
        help="local Dataset path",
    )
    parser.add_argument(
        "--enable-master-comm-opt",
        dest="enable_master_comm_opt",
        action="store_true",
        default=False,
        help="Enable communication optimization for MASTER in Spatial",
    )
    parser.add_argument(
        "--num-workers",
        type=int,
        default=0,
        help="Data loading workers (kept for CLI parity)",
    )
    parser.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="Stop after N steps per epoch (an addition to the reference, for smoke runs)",
    )
    parser.add_argument(
        "--precision",
        type=str,
        default="bf16",
        choices=["bf16", "fp32"],
        help="Compute precision (an addition to the reference; parameters stay f32)",
    )
    parser.add_argument(
        "--checkpoint-dir",
        type=str,
        default=None,
        help="Save checkpoints here (an addition to the reference, which has "
        "no persistence at all)",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=100,
        help="Steps between checkpoints (with --checkpoint-dir)",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        default=False,
        help="Resume from the newest checkpoint in --checkpoint-dir",
    )
    parser.add_argument(
        "--trace-dir",
        type=str,
        default=None,
        help="Write a torch.profiler Chrome trace of the training loop here, one "
        "file a rank",
    )
    parser.add_argument(
        "--eval-batches",
        type=int,
        default=0,
        help="After training: calibrate BN on N batches and evaluate on N "
        "more (an addition to the reference, which has no eval path)",
    )
    parser.add_argument(
        "--max-restarts",
        type=int,
        default=0,
        help="Supervise the run: on crash or hang, restart up to N times, "
        "resuming from the newest checkpoint",
    )
    parser.add_argument(
        "--hang-timeout",
        type=float,
        default=None,
        help="With --max-restarts: seconds without a training-step "
        "heartbeat before the child is declared wedged and restarted "
        "(must exceed the first step's time)",
    )
    parser.add_argument(
        "--device",
        type=str,
        default="cuda",
        help="Device to run on: cuda (the default) or cpu",
    )
    return parser
