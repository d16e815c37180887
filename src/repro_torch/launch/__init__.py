"""Launch drivers of the port (counterpart of ``repro.launch``): ``train``, the
``--arch svm_bsgd`` streamed-training arm, and ``serve``, the ``--arch
svm_bsgd`` serving arm with ``--live`` train-while-serve.  Run them as modules
(``python -m repro_torch.launch.train``, ``python -m repro_torch.launch.serve``)."""
