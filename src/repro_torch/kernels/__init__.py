"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

lstm_cell   grouped fused LSTM step (RevPred's hot spot); replaces the
            Pallas kernel ``repro.kernels.lstm_cell.lstm_cell_pallas``
ops         device dispatch: CPU tensors -> ``ref``, CUDA tensors -> kernel
ref         the plain versions
build       nvcc at first use into ``build/kernels/``
"""
