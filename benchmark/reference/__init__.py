"""Plain PyTorch / NumPy references of the benchmark: the transfer_em U-Net
generator and discriminator (``models``), the train step with its focal
losses and Keras Adam (``train``), the data pipeline's draws and transforms
(``pipeline``) and tiled volume prediction (``infer``).  They import
nothing of the system under test and take nothing it made: the benchmark
hands them the same seeded inputs and weights it hands the system.
"""
