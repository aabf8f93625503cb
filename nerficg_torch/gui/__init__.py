"""The interactive viewer: shared state (``state``), the web viewer process
(``web_viewer``) and GUI-attached training (``trainer``). Port of
nerficg_tpu/gui/. The package imports nothing itself, so that the spawned
viewer process loads only ``state`` and ``web_viewer``, never ``torch``."""
