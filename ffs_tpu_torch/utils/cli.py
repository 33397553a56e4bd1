"""Shared CLI argument plumbing mirroring the reference's FFSArgumentParser.

Every reference binary built on FFSArgumentParser (spotfinder and the GPU
integrator via CUDAArgumentParser, the baseline integrator directly) gets
two behaviours beyond its own flags (reference: src/ffs/arg_parser.cc:36-89):

* ``-v``/``--verbose`` — verbose logging output.  Our logging threshold is
  the ``LOG_LEVEL`` env consumed by :func:`.logging.setup_logging`,
  so the flag maps to forcing ``LOG_LEVEL=debug`` for the process (and any
  child it spawns).
* a ``common.args`` file in the working directory — each non-empty line is
  appended as an extra argument unless that exact string is already present
  (reference: arg_parser.cc:58-70).  This is how deployments pin per-beamline
  defaults without editing the service command line.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def add_common_arguments(parser):
    """Add the FFSArgumentParser-shared flags to ``parser``."""
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="Verbose output"
    )
    return parser


def expand_common_args(argv=None) -> list[str]:
    """Return the effective argv with ``common.args`` lines appended.

    Mirrors FFSArgumentParser::parse_args (reference: arg_parser.cc:53-70):
    every non-empty line of a ``common.args`` file in the cwd is appended
    unless an identical argument string is already present.
    """
    args = list(sys.argv[1:] if argv is None else argv)
    path = Path("common.args")
    if path.exists():
        try:
            lines = path.read_text().splitlines()
        except OSError:
            return args
        for line in lines:
            if line and line not in args:
                args.append(line)
    return args


def apply_verbosity(args) -> None:
    """Honour a parsed ``--verbose`` flag by raising the log threshold."""
    if getattr(args, "verbose", False):
        os.environ["LOG_LEVEL"] = "debug"
