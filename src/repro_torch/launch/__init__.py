"""Launch drivers of the port (counterpart of ``repro.launch``): ``serve``, the
``--arch svm_bsgd`` serving arm.  Run them as modules
(``python -m repro_torch.launch.serve``)."""
