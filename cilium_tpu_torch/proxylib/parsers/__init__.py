"""L7 rule-parser registrations (import side effects).

Like the reference's per-parser ``init()`` functions
(reference: proxylib/r2d2/r2d2parser.go:133-137).  The port registers the
test parsers (``test.passer``, ``test.lineparser``, ``test.blockparser``,
``test.headerparser``) and the r2d2, HTTP, DNS, Cassandra and memcached
parsers, as the JAX package does.
"""

from . import testparsers  # noqa: F401
from . import r2d2  # noqa: F401
from . import cassandra  # noqa: F401
from . import memcached  # noqa: F401
from . import http  # noqa: F401
from . import dns  # noqa: F401
