from . import framework  # noqa: F401
from . import basic  # noqa: F401  (registers coll/basic)
from . import tuned  # noqa: F401  (registers coll/tuned)
from . import nbc  # noqa: F401  (registers coll/nbc — nonblocking)
from . import device  # noqa: F401  (registers coll/tpu, coll/hbm, arr_host)
from . import sm  # noqa: F401  (registers coll/sm — thread-rank meetings)
from . import seg  # noqa: F401  (registers coll/seg — same-node process segments)
