"""The benchmark's harness: the cell's files (:mod:`.spec`), the clients'
base (:mod:`.client`), one run (:mod:`.core`) and the traced window
(:mod:`.trace`)."""
