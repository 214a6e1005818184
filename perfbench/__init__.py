"""The benchmark of neo_ls_svm_torch: python3 perfbench/run.py --workload <cell> ..."""
