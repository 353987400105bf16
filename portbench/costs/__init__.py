"""Operations and bytes of the program's kernels, counted from shapes:
one module a kernel."""
