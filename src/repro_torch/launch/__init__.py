"""Launch tools of the port: ``serve.py``, ``harvest_serving.py``, ``train.py``
and ``train_lm.py`` (the rest come with a later slice)."""
