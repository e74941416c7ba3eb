"""The port's benchmark CLI (``mpi4dl_tpu_torch.parser``) against the JAX
package's (``mpi4dl_tpu.parser``): for the default argv and for argvs that
set every flag, the parsed namespaces are equal except the port's
``--device`` (``cuda`` unless asked otherwise); both refuse the same bad
``--precision``."""

import pytest

from mpi4dl_tpu.parser import get_parser as jax_parser
from mpi4dl_tpu_torch.parser import get_parser

FULL = [
    "--verbose", "--batch-size", "2", "--parts", "4", "--split-size", "3",
    "--num-spatial-parts", "4,2", "--spatial-size", "2", "--times", "2",
    "--image-size", "1024", "--num-epochs", "3", "--num-layers", "6",
    "--num-filters", "64", "--num-classes", "100", "--balance", "1,2,3", "--halo-D2",
    "--fused-layers", "2", "--local-DP", "4", "--slice-method", "vertical", "--app", "2",
    "--datapath", "/data/x", "--enable-master-comm-opt", "--num-workers", "2",
    "--max-steps", "7", "--precision", "fp32", "--checkpoint-dir", "ck",
    "--checkpoint-every", "5", "--resume", "--trace-dir", "tr", "--eval-batches", "3",
    "--max-restarts", "2", "--hang-timeout", "30.5",
]


@pytest.mark.parametrize("argv", [[], FULL, ["-v", "--split-size", "1", "--precision", "bf16"]],
                         ids=["defaults", "every_flag", "short_verbose"])
def test_parses_as_the_jax_parser(argv):
    got = vars(get_parser().parse_args(argv))
    want = vars(jax_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


def test_device_flag_and_split_size_default():
    args = get_parser().parse_args(["--device", "cpu"])
    assert args.device == "cpu" and args.split_size == 2


def test_precision_choices_refused_alike():
    for parser in (get_parser(), jax_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--precision", "fp16"])
