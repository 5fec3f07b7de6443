"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

lstm_cell   grouped fused LSTM step (RevPred's hot spot), the whole stack
            in one launch, and the stack's training forward and backward
            (``LstmStack``); replaces the Pallas kernel
            ``repro.kernels.lstm_cell.lstm_cell_pallas``
soa_step_cuda  the SoA round's EWMA fold + boundary min; replaces
            ``repro.kernels.soa_step.soa_step_fused`` and ``ewma_fold``
flash_attention_cuda  blocked online-softmax attention (the model server's
            prefill); replaces ``repro.kernels.flash_attention``
ssd_chunk_cuda  one Mamba2 SSD chunk (every Mamba layer's prefill);
            replaces ``repro.kernels.ssd_scan.ssd_chunk_pallas``
ops         device dispatch: CPU tensors -> ``ref``, CUDA tensors -> kernel
ref         the plain versions
build       nvcc at first use into ``build/kernels/``
_grad       ``check_no_grad``, which every kernel without a backward calls
"""
