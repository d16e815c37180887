"""Launch drivers of the port (counterpart of ``repro.launch``): ``train``, the
language models' trainer (``--arch <lm>``) and the ``--arch svm_bsgd``
streamed-training arm; ``serve``, the language models' and the ``--arch
svm_bsgd`` serving arms with ``--live`` train-while-serve; ``steps``, the
train, prefill and decode step functions; ``elastic``, the trainer's
restart supervisor; ``dist`` starts the process group of a distributed
run, and ``mesh`` makes its ``DeviceMesh``.  Run ``train``, ``serve`` and ``elastic`` as modules (``python -m
repro_torch.launch.train``).  The dry run: ``inputs`` (abstract arguments),
``roofline`` (the card's ``DeviceSpec``, the counters, the kernels' work
formulas) and ``dryrun``, which owns its process (it starts a fake process
group) and is never imported here."""
