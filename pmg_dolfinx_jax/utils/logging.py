"""Logging setup (the spdlog / dolfinx `init_logging` analogue).

Process-index aware: on multi-host meshes only process 0 logs at INFO by
default (the reference prints rank-0 banners, examples/pmg/main.cpp:134-149).
"""

import logging
import sys


def init_logging(level=logging.INFO, all_processes=False):
    import jax

    if not all_processes and jax.process_index() != 0:
        level = logging.WARNING
    logging.basicConfig(
        stream=sys.stdout,
        level=level,
        format="[%(asctime)s %(name)s %(levelname).1s] %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )


def get_logger(name="pmg"):
    return logging.getLogger(name)
