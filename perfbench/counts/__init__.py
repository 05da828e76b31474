"""Operations and bytes counted from the work's shapes, and the card's
peaks: the yardstick of the benchmark's MFU and roofline shares. Nothing
here reads the program: a later change to how a step is computed reads
against the same counts."""
