"""A process of the port's multi-process CLI tests (`tests/test_torch_multiprocess.py`).

    python torch_cli_worker.py RANK WORLD PORT train ARGS...
        the training CLI as rank RANK of WORLD, rendezvous at
        127.0.0.1:PORT (--coordinator/--num-processes/--process-id);
    python torch_cli_worker.py 0 1 PORT spawn N ARGS...
        the inference CLI's `run_ranks` over N gloo ranks on the CPU.

Exits with the CLI's code. Imports no JAX.
"""

import sys

import torch


def main() -> int:
    rank, world, port, mode, *args = sys.argv[1:]
    torch.set_num_threads(1)
    if mode == "train":
        from demucs_tpu_torch.tools.train_cli import main as train_main

        return train_main(args + ["--coordinator", f"127.0.0.1:{port}",
                                  "--num-processes", world, "--process-id", rank])
    from demucs_tpu_torch import cli

    n, *args = args
    return cli.run_ranks(cli._parse(args), int(n), backend="gloo")


if __name__ == "__main__":
    sys.exit(main())
