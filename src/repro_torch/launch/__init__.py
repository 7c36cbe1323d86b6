"""Launch tools of the port: ``serve.py``, ``harvest_serving.py``, ``train.py``,
``train_lm.py``, the production meshes (``mesh.py``), the H100 roofline
(``roofline.py``), the meta-device dry run (``dryrun.py``), and the twins of
``examples/quickstart.py`` and ``examples/elastic_faas_demo.py``."""
