"""Every configuration's tiny size, before any test cuts a checkout."""

import simbench.tests.tiny_sizes  # noqa: F401
