"""Plain references the benchmark judges the program's answers by. They
use numpy and plain torch only, and import nothing of the program."""
