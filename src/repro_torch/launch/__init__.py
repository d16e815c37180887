"""Launch drivers of the port (counterpart of ``repro.launch``): ``train``, the
language models' trainer (``--arch <lm>``) and the ``--arch svm_bsgd``
streamed-training arm; ``serve``, the language models' and the ``--arch
svm_bsgd`` serving arms with ``--live`` train-while-serve; ``steps``, the
train, prefill and decode step functions; ``elastic``, the trainer's
restart supervisor; ``dist`` starts the process group of a distributed
run, and ``mesh`` makes its ``DeviceMesh``.  Run ``train``, ``serve`` and ``elastic`` as modules (``python -m
repro_torch.launch.train``)."""
