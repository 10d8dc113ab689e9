"""Host-side optimizers (float64): the 1-D sectioning search, gradient and
quasi-Newton searches, and the genetic-algorithm search.
"""

from .qs1dsearch import OptimDirection, Qs1dSearch  # noqa: F401
from .gradsearch import GradSearch, QnSearch  # noqa: F401
from .gasearch import Chromosome, GaSearch  # noqa: F401
