"""The offline discrete-token pipeline's command lines (counterparts of
``scripts/segment_embeddings.py``, ``scripts/mean_segment_embeddings.py``
and ``scripts/quantize_embeddings.py``), run as
``python -m aat_tpu_torch.scripts.<name>``. They default to ``cuda:0`` and
raise without a GPU (:func:`aat_tpu_torch.runtime.device.resolve_device`);
``main(argv, device="cpu")`` runs the plain versions."""
