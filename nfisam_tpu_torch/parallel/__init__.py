from .scheduler import ParallelNFiSAM, wavefronts
