"""Launch tools of the port (``serve.py``; the rest come with a later slice)."""
