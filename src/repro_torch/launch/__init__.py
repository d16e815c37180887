"""Launch drivers of the port (counterpart of ``repro.launch``): ``train``, the
``--arch svm_bsgd`` streamed-training arm, and ``serve``, the ``--arch
svm_bsgd`` serving arm with ``--live`` train-while-serve; ``dist`` starts the
process group of a distributed run.  Run ``train`` and ``serve`` as modules
(``python -m repro_torch.launch.train``, ``python -m repro_torch.launch.serve``)."""
