"""ompi_tpu_torch: the port of ompi_tpu to PyTorch and CUDA.

It sits beside the reference package ``ompi_tpu`` (JAX), keeps its
module paths, names and MCA parameter names, and imports nothing of
it.  Ranks that share one card meet at a rendezvous and one
hand-written kernel (kernels/csrc/stacked.cu) computes the whole
collective.

Process ranks, launched by the port's mpirun:

    # prog.py
    import ompi_tpu_torch
    comm = ompi_tpu_torch.init()
    ...
    ompi_tpu_torch.finalize()

    $ python -m ompi_tpu_torch.tools.mpirun -np 4 prog.py

``--ranks-per-proc N|all`` runs N ranks as threads of one app shell
(tools/hostrun.py); ``--devices auto`` (the default) gives rank r the
card r % count and fails when there is none, ``--devices cpu`` runs
the ranks on the CPU, ``--devices none`` gives them no device.

Thread ranks in one process:

    import torch
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.testing import run_ranks

    def fn(comm):
        x = torch.ones(1 << 20, device=comm.device)
        return comm.allreduce_arr(x, SUM)

    run_ranks(8, fn, device_map=lambda r: torch.device("cuda", 0))

``run_ranks(n, fn, devices=True)`` maps rank i to card i % count and
raises when there is no card; the CPU is used only when the caller
asks for it with ``device_map=lambda r: torch.device("cpu")``.

Sessions resident in a pool (tools/dvm.py), where init() finds the
pool's warm world and finalize() is a run boundary:

    $ python -m ompi_tpu_torch.tools.dvm --np 8 --uri-file /tmp/dvm.uri &
    $ python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 4 prog.py
    $ python -m ompi_tpu_torch.tools.dvm --halt /tmp/dvm.uri
"""

from __future__ import annotations

__version__ = "0.1.0"

_finalized_once = False


def _named_device(choice: str, rte):
    """The device ``init(device="auto"|"cpu")`` names: the one the app
    shell or the pool assigned this rank when there is one (which must
    then be of that kind), else the CPU, or for ``auto`` the card
    ``rank % count`` (no card: RuntimeError — never a silent CPU)."""
    import torch
    given = getattr(rte, "default_device", None)
    kind = getattr(given, "device", given)  # a LogicalDevice's card
    want = {"auto": "cuda", "cpu": "cpu"}.get(choice)
    if want is None:
        raise ValueError(f"device {choice!r}: auto, cpu or a torch.device")
    if given is not None:
        if kind.type != want:
            raise RuntimeError(
                f"device {choice!r}: rank {rte.rank} was given {given} "
                f"by its app shell or pool")
        return given
    if want == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'auto': no CUDA card is visible to "
                           f"rank {rte.rank} (name 'cpu' to use the CPU)")
    return torch.device("cuda", rte.rank % torch.cuda.device_count())


def init(device=None):
    """MPI_Init analog: bootstrap this process's rank and return
    COMM_WORLD (ref: ompi/mpi/c/init.c → ompi_mpi_init.c).  Without a
    launcher it is a 1-rank world with no device unless ``device`` (a
    ``torch.device``) is given; a rank of an app shell gets the device
    the shell assigned it.  ``device="auto"`` or ``"cpu"`` names the
    kind instead (see ``_named_device``): the examples' ``--device``."""
    from ompi_tpu_torch.runtime import state as statemod
    from ompi_tpu_torch.runtime.init import mpi_init
    from ompi_tpu_torch.runtime.rte import HybridRTE, make_rte

    existing = statemod.maybe_current()
    if existing is not None and existing.initialized \
            and not existing.finalized:
        return existing.comm_world
    rte = make_rte()
    st = statemod.ProcState(rte.rank, rte.size, rte)
    if isinstance(device, str):
        device = _named_device(device, rte)
    elif device is None:
        # hybrid launch: the app shell pre-assigned this rank-thread a
        # device (mpirun --ranks-per-proc, see tools/hostrun.py)
        device = getattr(rte, "default_device", None)
    mpi_init(st, device=device)
    # process-wide publication is a convenience for single-rank
    # processes only; with co-resident rank-threads it would hand an
    # arbitrary rank's state to non-rank threads (last writer wins)
    # instead of the clean not-initialized error
    statemod.set_current(st, process_wide=not isinstance(rte, HybridRTE))
    return st.comm_world


def finalize() -> None:
    """MPI_Finalize analog (ref: ompi_mpi_finalize.c:101)."""
    from ompi_tpu_torch.runtime import state as statemod
    from ompi_tpu_torch.runtime.init import mpi_finalize

    global _finalized_once
    st = statemod.maybe_current()
    if st is not None and st.initialized and not st.finalized:
        if st.serve_resident:
            # a session resident in the pool (tools/dvm.py): the world
            # outlives the program.  Finalize is a run boundary — flush
            # deferred fused batches and meet the peers — so the next
            # program of this session starts from a quiet, still-warm
            # world.  Real teardown happens at detach, when the pool
            # clears serve_resident.
            from ompi_tpu_torch.coll import fusion as _fusion
            _fusion.flush_state(st)
            st.rte.fence()
            return
        mpi_finalize(st)
        _finalized_once = True


def attach_buffer(size_or_buf) -> None:
    """MPI_Buffer_attach for this rank (Bsend backing store)."""
    from ompi_tpu_torch.pml.persistent import attach_buffer as _attach
    from ompi_tpu_torch.runtime import state as statemod

    _attach(statemod.current(), size_or_buf)


def detach_buffer() -> int:
    """MPI_Buffer_detach: drains pending buffered sends."""
    from ompi_tpu_torch.pml.persistent import detach_buffer as _detach
    from ompi_tpu_torch.runtime import state as statemod

    return _detach(statemod.current())


def get_parent():
    """MPI_Comm_get_parent: in a spawned job, the intercommunicator
    to the spawning processes; None otherwise."""
    from ompi_tpu_torch.comm.dpm import get_parent as _gp
    from ompi_tpu_torch.runtime import state as statemod

    return _gp(statemod.current().comm_world)


def open_port() -> str:
    from ompi_tpu_torch.comm.dpm import open_port as _op
    from ompi_tpu_torch.runtime import state as statemod

    return _op(statemod.current())


def publish_name(service: str, port: str) -> None:
    from ompi_tpu_torch.comm.dpm import publish_name as _pn
    from ompi_tpu_torch.runtime import state as statemod

    _pn(statemod.current(), service, port)


def lookup_name(service: str) -> str:
    from ompi_tpu_torch.comm.dpm import lookup_name as _ln
    from ompi_tpu_torch.runtime import state as statemod

    return _ln(statemod.current(), service)


def initialized() -> bool:
    from ompi_tpu_torch.runtime import state as statemod

    st = statemod.maybe_current()
    return st is not None and st.initialized


def finalized() -> bool:
    """MPI_Finalized: True once finalize() has completed (the state
    itself is dropped from current() at finalize, so track it here)."""
    return _finalized_once
