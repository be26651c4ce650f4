"""Entry points: one module per kind of request, each a class ``Entry``
that sets the program up from a pool and answers one request."""
