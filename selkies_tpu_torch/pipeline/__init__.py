"""The port's asyncio pipeline and app core (``TorchWebRTCApp``).

Counterpart of ``selkies_tpu/pipeline/`` less its capture module: the
sources, ``VideoPipeline`` and ``EncodedFrame`` (``elements.py``) and the
solo serving app (``app.py``), whose byte plane is a ``Transport`` the
caller passes in.
"""
