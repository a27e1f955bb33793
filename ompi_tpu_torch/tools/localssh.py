"""localssh: a launch-agent shim that runs the "remote" command
locally, ignoring the hostname argument (port of the reference's
tools/localssh.py).

The testing stand-in for ssh in the PLM (the reference tests its rsh
tree-launch the same way — an agent that isn't really remote; ref:
plm_rsh's settable agent, orte/mca/plm/rsh).  Usage as an agent:

    mpirun --hosts a,b --launch-agent "python -m ompi_tpu_torch.tools.localssh"

argv[1] is the host name (dropped), the remainder is the command —
either already-split argv or a single shell string (as real ssh gets).
"""

from __future__ import annotations

import subprocess
import sys


def main() -> int:
    if len(sys.argv) < 3:
        sys.stderr.write("localssh: usage: localssh <host> <command...>\n")
        return 2
    rest = sys.argv[2:]
    if len(rest) == 1:
        return subprocess.call(rest[0], shell=True)
    return subprocess.call(rest)


if __name__ == "__main__":
    sys.exit(main())
