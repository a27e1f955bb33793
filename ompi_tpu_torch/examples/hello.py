"""ref: examples/hello_c.c"""
import ompi_tpu_torch
comm = ompi_tpu_torch.init()
print(f"Hello, world, I am {comm.rank} of {comm.size}", flush=True)
ompi_tpu_torch.finalize()
