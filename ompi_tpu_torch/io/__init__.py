"""MPI-IO (io/ompio analog): the port of the reference's io package,
the same host-side file layer over numpy buffers.

    from ompi_tpu_torch import io as mpiio
    f = mpiio.open(comm, "data.bin", mpiio.MODE_CREATE | mpiio.MODE_RDWR)
    f.write_at(comm.rank * n, arr)
    f.close()
"""

from ompi_tpu_torch.io.file import (  # noqa: F401
    File, open, delete,
    MODE_APPEND, MODE_CREATE, MODE_DELETE_ON_CLOSE, MODE_EXCL,
    MODE_RDONLY, MODE_RDWR, MODE_SEQUENTIAL, MODE_UNIQUE_OPEN,
    MODE_WRONLY, SEEK_CUR, SEEK_END, SEEK_SET,
)
from ompi_tpu_torch.io.view import FileView  # noqa: F401
